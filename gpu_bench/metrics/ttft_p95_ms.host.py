"""``ttft_p95_ms`` where the host sets the pace: the same arithmetic over
every request due in the window, kept as a per-layer metric because the
device is idle most of the traced slice (PERF.md)."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve":
        return None
    return readers.p95_ms(readers.ttfts(rec))
