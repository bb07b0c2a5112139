"""``itl_p95_ms`` where the host sets the pace (see ``ttft_p95_ms.host``)."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve":
        return None
    return readers.p95_ms(readers.gaps(rec))
