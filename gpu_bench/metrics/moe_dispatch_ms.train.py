"""Milliseconds of the traced step in which the device was idle while the
MoE block's work around its expert products was open in the port
(``moe.route``, ``moe.dispatch``, ``moe.combine``; the forward's and the
backward's recompute, on either thread): the dispatch holding the card
back, not the host's wall time in it, which a full launch queue fills
too."""

from gpu_bench import program


def read(rec):
    if rec["kind"] != "train":
        return None
    return program.idle_ms(rec, program.MOE_DISPATCH)
