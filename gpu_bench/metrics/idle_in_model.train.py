"""Share of the traced step in which the device was idle while a
``model.*`` or ``moe.*`` span of the port was open, on either thread
(the backward's recompute runs on autograd's)."""

from gpu_bench import program


def read(rec):
    if rec["kind"] != "train":
        return None
    return program.idle_share(rec, ("model.", "moe."))
