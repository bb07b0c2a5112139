"""Host time of each tick of the window (the port's ``engine.step`` span)
less its model calls (``model.*``), its waits on the device (``*.sync``)
and the scheduler's passes: the engine's own bookkeeping, mean in ms."""

from gpu_bench import program


def read(rec):
    return program.bookkeeping_ms(rec) if rec["kind"] == "serve" else None
