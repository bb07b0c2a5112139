"""Rates and tails are taken over all the work and all the time of the
window, on a synthetic record that holds a stall."""

import importlib

from conftest import REPO

from gpu_bench import readers, run


def record():
    """Window [10, 20): 20 requests due each half second, each served
    its first token 0.1 s after due and then a token every 0.05 s for 10
    tokens, except that nothing at all comes out between 14 and 16 s."""
    reqs = []
    for i in range(20):
        due = 10 + 0.5 * i
        times, t = [], due + 0.1
        while len(times) < 10:
            if 14 <= t < 16:
                t = 16.0
            times.append(t)
            t += 0.05
        reqs.append({"due": due, "times": times, "state": "done",
                     "suspended": False, "group": "g", "shared": 0})
    return {"kind": "serve", "seconds": 10, "window": (10.0, 20.0),
            "requests": reqs, "steps": [], "stopped_at": 21.0}


def metric(name, rec):
    return run.reader(REPO, name).read(rec)


def test_rate_is_all_tokens_over_all_the_window():
    rec = record()
    inside = sum(1 for r in rec["requests"] for t in r["times"]
                 if 10 <= t < 20)
    assert metric("serve_tokens_per_s", rec) == inside / 10


def test_tails_see_the_stall():
    rec = record()
    ttft = readers.ttfts(rec)
    assert len(ttft) == 20
    # requests due inside the stall wait for its end
    assert max(ttft) > 1.0
    assert metric("ttft_p95_ms.host", rec) > 1000
    gaps = readers.gaps(rec)
    assert max(gaps) > 1.5 and metric("itl_p95_ms.host", rec) >= 50


def test_a_request_without_first_token_misses():
    rec = record()
    for r in rec["requests"][-3:]:
        r["times"], r["state"] = [], "failed"
    assert metric("ttft_p95_ms.host", rec) is None  # over 5 % missing
    # above the knee the wait until the loop stopped stands for it
    assert metric("ttft_p95_ms.over_knee", rec) >= 1e3 * (21.0 - 19.0)


def test_percentile_is_nearest_rank():
    assert readers.percentile(list(range(101)), 0.95) == 95
    assert readers.percentile([], 0.5) is None


def test_every_reader_returns_nothing_without_its_source():
    empty_train = {"kind": "train", "step_ends": [], "trace": None,
                   "untraced_step_s": [],
                   "peak_window_bytes": 0, "calls": []}
    for path in (REPO / "gpu_bench" / "metrics").glob("*.py"):
        name = path.stem
        if name == "setup_s":
            continue
        val = run.reader(REPO, name).read(empty_train)
        assert val is None, name
    assert importlib.import_module("gpu_bench.readers")
