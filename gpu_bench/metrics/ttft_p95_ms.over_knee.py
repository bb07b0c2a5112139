"""``ttft_p95_ms``'s arithmetic above the knee, where the queue grows:
a request with no first token when the loop stopped counts with its wait
until then (a lower bound), so the tail stays a number."""

from gpu_bench import readers


def read(rec):
    if rec["kind"] != "serve":
        return None
    w0, w1 = rec["window"]
    end = rec["stopped_at"]
    vals = sorted((r["times"][0] if r["times"] else end) - r["due"]
                  for r in rec["requests"] if w0 <= r["due"] < w1)
    return readers.p95_ms(vals)
