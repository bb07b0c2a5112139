"""Host time of the scheduler's passes (``engine.policy``,
``engine.demote``, ``engine.tiers``) per tick of the window, in ms, from
the port's own spans."""

from gpu_bench import program


def read(rec):
    if rec["kind"] != "serve":
        return None
    return program.per_top(rec, "engine.step", program.SCHEDULER)
