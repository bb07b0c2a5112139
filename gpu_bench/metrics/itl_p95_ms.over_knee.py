"""``itl_p95_ms``'s arithmetic above the knee."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve":
        return None
    return readers.p95_ms(readers.gaps(rec))
