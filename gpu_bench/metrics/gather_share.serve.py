"""Device time of the kernels launched inside the port's
``model.pool_gather`` spans (the paged decode's pool-view gather and
copy) over the traced slice's busy time, in %."""

from gpu_bench import program


def read(rec):
    p = program.program(rec)
    if rec["kind"] != "serve" or p is None or rec["trace"]["busy_s"] <= 0:
        return None
    return (100.0 * p["device_s"].get("model.pool_gather", 0.0)
            / rec["trace"]["busy_s"])
