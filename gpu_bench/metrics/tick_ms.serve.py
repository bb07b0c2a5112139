"""Median host time of ``ServingEngine.step()`` over the steps that began
inside the window (the benchmark's span around each call)."""

from gpu_bench import readers


def read(rec):
    return readers.tick_ms(rec) if rec["kind"] == "serve" else None
