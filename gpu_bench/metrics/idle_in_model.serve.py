"""Share of the traced slice in which the device was idle while a
``model.*`` span of the port was open: the model's eager dispatch
leaving the card waiting on the host."""

from gpu_bench import program


def read(rec):
    if rec["kind"] != "serve":
        return None
    return program.idle_share(rec, ("model.",))
