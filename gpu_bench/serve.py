"""A serving cell: the port's ServingEngine under MursPolicy, driven by an
open loop of requests due on the wall clock, then the check of what it
served against the plain reference.

Time runs from the start of the traffic.  Requests are submitted when
due, whether or not earlier ones have finished; the engine steps while
it has work.  The traffic's first ``warm_s`` seconds fill the batch (set-
up the traffic needs); the window is the next ``--seconds``; after it the
loop runs on, still submitting on schedule, until every request due in
the window has its first token or ``grace_s`` has passed.  A token's time
is the end of the step that produced it.  A traced run profiles
``slice_s`` seconds of the same traffic right after the window.
"""

from __future__ import annotations

import gc
import json
import time
from typing import Dict, List

import numpy as np
import torch

from . import port, traffic, weights
from . import trace as tr


def run(ctx) -> dict:
    """Set up, serve the window, free the program, check; the run's
    record for the metric readers."""
    config, mix, dev = ctx.config, ctx.traffic, ctx.device
    model = config["model"]
    if dev == "cuda":
        port.build_kernels()
    ctx.log("kernels built")
    params = weights.program_tree(model, weights.make(model, ctx.seed, dev))
    cfg = port.arch(config)
    eng = port.engine(config, cfg, params, dev)
    plan = traffic.plan(mix, ctx.seed, model["vocab_size"])
    ctx.log("weights, engine and traffic made; the open loop starts")
    rec = drive(ctx, eng, plan, mix)
    rec["peak_bytes"] = max(rec["setup_peak_bytes"], (
        torch.cuda.max_memory_allocated() if dev == "cuda" else 0))
    ctx.log(f"loop stopped at {rec['stopped_at']:.2f} s of traffic; "
            f"{len(rec['steps'])} steps in the window")
    served = sample(ctx, rec, plan, mix)
    rec.pop("reqs")
    del eng, params
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    rec["check"] = check(ctx, served)
    ctx.log(f"checked {rec['check']['requests']} requests, "
            f"{rec['check']['tokens']} tokens")
    return rec


def drive(ctx, eng, plan: List[traffic.Planned], mix: dict) -> dict:
    seconds = ctx.seconds
    w0 = float(mix["warm_s"])
    w1 = w0 + seconds
    stop_by = w1 + float(mix["grace_s"])
    # the traced slice follows the window, while the loop runs on: the
    # profiler takes seconds to start, and that stall falls outside the
    # window; its events are reduced once the loop is over
    slice_end = None
    info = [{"due": p.due, "times": [], "state": "", "suspended": False,
             "group": p.group, "shared": p.shared} for p in plan]
    reqs = {}
    live: Dict[str, list] = {}
    steps = []
    backlog = []
    lateness = 0.0
    counters0 = counters1 = launches0 = launches1 = None
    setup_peak = 0
    calls: List[tuple] = []
    sl = tr.Slice() if ctx.trace else None
    slice_state = "before" if ctx.trace else "off"
    rec_cm = None
    nxt = 0
    spans = []
    if ctx.trace:
        spans = [tr.patched(eng, "_admit", "admit"),
                 tr.patched(eng, "_prefill_tick", "prefill"),
                 tr.patched(eng, "_decode_tick", "decode"),
                 tr.patched(eng, "_policy_pass", "policy")]
        for cm in spans:
            cm.__enter__()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    clock0 = time.perf_counter()
    ctx.window_open = clock0 + w0
    try:
        while True:
            now = time.perf_counter() - clock0
            while nxt < len(plan) and plan[nxt].due <= now:
                p = plan[nxt]
                req = port.request(p)
                reqs[p.rid] = req
                eng.submit(req)
                live[p.rid] = [req, 0, nxt]
                lateness = max(lateness, now - p.due)
                nxt += 1
            if counters0 is None and now >= w0:
                counters0, launches0 = (port.engine_counters(eng),
                                        port.launches())
                if ctx.device == "cuda":
                    setup_peak = torch.cuda.max_memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
            if counters1 is None and now >= w1:
                counters1, launches1 = (port.engine_counters(eng),
                                        port.launches())
            if sl is not None:
                if slice_state == "before" and now >= w1:
                    sl.start()
                    slice_end = time.perf_counter() - clock0 + mix["slice_s"]
                    rec_cm = port.record_calls(calls)
                    rec_cm.__enter__()
                    slice_state = "on"
                elif slice_state == "on" and now >= slice_end:
                    rec_cm.__exit__(None, None, None)
                    sl.end()
                    slice_state = "done"
            if now >= w1 and slice_state in ("done", "off"):
                due_in = [i for i in range(nxt) if w0 <= info[i]["due"] < w1]
                if now >= stop_by or all(
                        info[i]["times"] or info[i]["state"] == "failed"
                        for i in due_in):
                    break
            if not eng.has_pending:
                if nxt < len(plan):
                    time.sleep(min(0.002, max(0.0, plan[nxt].due - now)))
                    continue
                if now >= w1:
                    break
                time.sleep(0.002)
                continue
            paged0 = eng.paged_decode_ticks
            t0 = time.perf_counter() - clock0
            with tr.span("step"):
                eng.step()
            t1 = time.perf_counter() - clock0
            new = 0
            for rid, ent in list(live.items()):
                req = ent[0]
                n = len(req.generated)
                row = info[ent[2]]
                if n > ent[1]:
                    row["times"].extend([t1] * (n - ent[1]))
                    new += n - ent[1]
                    ent[1] = n
                st = req.state
                if st in ("suspended", "offloaded"):
                    row["suspended"] = True
                if st in ("done", "failed"):
                    row["state"] = st
                    del live[rid]
            if w0 <= t0 < w1:
                steps.append((t0, t1, new, eng.paged_decode_ticks > paged0))
            backlog.append((t1, len(live)))
    finally:
        for cm in spans:
            cm.__exit__(None, None, None)
        if slice_state == "on":
            rec_cm.__exit__(None, None, None)
        if slice_state in ("on", "done"):
            sl.stop()
    stopped_at = time.perf_counter() - clock0
    if counters1 is None:
        counters1, launches1 = port.engine_counters(eng), port.launches()
    for rid, ent in live.items():
        info[ent[2]]["state"] = ent[0].state
    return {
        "kind": "serve", "seconds": seconds, "window": (w0, w1),
        "model": ctx.config["model"], "steps": steps, "requests": info[:nxt],
        "counters": (counters0, counters1), "launches": (launches0, launches1),
        "trace": sl.summary if sl is not None else None, "calls": calls,
        "lateness_s": lateness, "reqs": reqs, "stopped_at": stopped_at,
        "backlog": backlog, "setup_peak_bytes": setup_peak,
    }


def sample(ctx, rec, plan, mix) -> List[dict]:
    """The requests to check, drawn from the seed: of those finished, the
    longest, those that were suspended or demoted (up to half), one that
    began with a shared prompt, and others, ``mix["check_requests"]`` in
    all; then up to a quarter as many that were suspended, resumed and
    are still decoding.  Their prompts and served tokens, on the host."""
    w0 = rec["window"][0]
    done = [i for i, r in enumerate(rec["requests"])
            if r["state"] == "done" and r["times"] and r["times"][-1] >= w0]
    if not done:
        return []
    rng = np.random.default_rng([int(ctx.seed) & (2**64 - 1), 0xC4EC])
    n = mix["check_requests"]
    total = {i: len(plan[i].prompt) + plan[i].max_new_tokens for i in done}
    pick = [max(done, key=lambda i: (total[i], -i))]
    susp = [i for i in done if rec["requests"][i]["suspended"]
            and i not in pick]
    pick += [int(i) for i in rng.permutation(susp)[: n // 2]]
    shared = [i for i in done if rec["requests"][i]["shared"]
              and i not in pick]
    pick += [int(i) for i in rng.permutation(shared)[:1]]
    rest = [i for i in done if i not in pick]
    pick += [int(i) for i in rng.permutation(rest)[: max(0, n - len(pick))]]
    # suspended requests that resumed and are still decoding: every token
    # served so far is final, and each came from a rebuilt cache
    resumed = [i for i, r in enumerate(rec["requests"])
               if r["suspended"] and r["state"] == "decoding"
               and len(r["times"]) > 1]
    pick += [int(i) for i in rng.permutation(resumed)[: n // 4]]
    out = []
    for i in pick:
        req = rec["reqs"][plan[i].rid]
        out.append({"prompt": list(plan[i].prompt),
                    "served": [int(t) for t in req.generated],
                    "suspended": rec["requests"][i]["suspended"]})
    return out


@torch.no_grad()
def check(ctx, served: List[dict]) -> dict:
    """The widest gap by which a served token's logit lies below the
    reference's best at its position, over the sampled requests; with
    ``ctx.control``, also the gap of the token the float8 reference puts
    first at each of those positions."""
    from .reference import internlm2 as base
    from .reference import module

    model = ctx.config["model"]
    ref = module(ctx.config["reference"])
    base.no_tf32()
    w = {k: v.float() for k, v in weights.leaves(model, ctx.seed,
                                                 ctx.device)}
    gap = 0.0
    ctrl = 0.0
    n_tok = 0
    for s in served:
        toks = torch.tensor([s["prompt"] + s["served"][:-1]],
                            device=ctx.device)
        pos = torch.arange(len(s["prompt"]) - 1, toks.shape[1],
                           device=ctx.device)
        z = _logits_at(ref, model, w, toks, pos, lowp=False)
        got = torch.tensor(s["served"], device=ctx.device)
        best = z.max(dim=-1).values
        gap = max(gap, float((best - z.gather(1, got[:, None])[:, 0]).max()))
        n_tok += len(s["served"])
        if ctx.control:
            zl = _logits_at(ref, model, w, toks, pos, lowp=True)
            first = zl.argmax(dim=-1)
            ctrl = max(ctrl, float(
                (best - z.gather(1, first[:, None])[:, 0]).max()))
        del z
    out = {"max_logit_gap": gap, "tokens": n_tok, "requests": len(served),
           "suspended": sum(s["suspended"] for s in served)}
    if ctx.control:
        out["control_max_logit_gap"] = ctrl
    return out


def _logits_at(ref, model, w, toks, pos, lowp):
    """The reference's logits at positions ``pos`` of ``toks``."""
    from .reference.internlm2 import hidden, mm, unembed_weight

    h = hidden(model, w, toks, ffn=ref.FFN, lowp=lowp)[0, pos]
    return mm(h, unembed_weight(model, w), lowp)
