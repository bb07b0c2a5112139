"""A training cell: the port's Trainer step on batches of its
DataPipeline, token ids from the seed; then the check of its first three
steps against the plain reference.

Set-up builds one trainer over the benchmark's weights and drives it
through ``check_steps`` steps with the window's own call and feed; those
are the steps the reference follows.  Their readings are taken as they
happen: each step's loss, each leaf's first gradient as AdamW got it
(its first moment after one step over ``1 - b1``), each leaf's change
after the last of them (the weights regenerated from the seed one leaf
at a time), and in a mixture of experts the experts each token went to,
which the reference follows and judges.  The window then runs whole
steps until ``--seconds`` has passed, each ended by a synchronise.
"""

from __future__ import annotations

import functools
import gc
import math
import os
import time
from typing import Dict, List

import torch

from . import port, weights
from . import trace as tr

#: random directions along which a leaf's first gradient is read
SKETCH = 8
#: elements of a leaf read at a time
CHUNK = 1 << 26


@torch.no_grad()
def sketch(leaves: Dict[str, torch.Tensor], scale: float) -> Dict[str, list]:
    """Each leaf's projections on ``SKETCH`` Gaussian directions drawn
    from a fixed seed per leaf (the same on both sides), times ``scale``:
    the difference of two sketches over the norm of one estimates the
    relative norm of the difference of the two gradients."""
    out = {}
    for li, (name, g) in enumerate(leaves.items()):
        gen = torch.Generator(device=g.device)
        gen.manual_seed(0x5E7C4 + li)
        flat = g.reshape(-1)
        acc = torch.zeros(SKETCH, dtype=torch.float64, device=g.device)
        for i in range(0, flat.numel(), CHUNK):
            part = flat[i:i + CHUNK].float()
            r = torch.randn((SKETCH, part.numel()), generator=gen,
                            device=g.device)
            acc += (r @ part).double()
            del r
        out[name] = (acc * scale).tolist()
    return out


def run(ctx) -> dict:
    config, job, dev = ctx.config, ctx.traffic, ctx.device
    model = config["model"]
    B, S = job["batch"], job["seq"]
    if dev == "cuda":
        port.build_kernels()
    ctx.log("kernels built")
    params = weights.program_tree(model, weights.make(model, ctx.seed, dev))
    cfg = port.arch(config)
    trainer, shape = port.trainer(config, cfg, B, S, dev, ctx.seed,
                                  os.path.join(ctx.scratch, "ckpt"))
    trainer.init_params = lambda: params
    params, opt = trainer.build()
    step_fn = trainer._step
    pipe = port.pipeline(cfg, shape, ctx.seed, B, S, dev)
    b1 = config["train"]["adamw"]["b1"]
    batches, losses, routes = [], [], []
    gnorm: Dict[str, float] = {}
    gdir: Dict[str, list] = {}
    n_check = job["check_steps"]
    try:
        for i in range(n_check):
            batch = next(pipe)
            batches.append({k: v.cpu() for k, v in batch.items()})
            calls: List[torch.Tensor] = []
            with port.record_routes(calls):
                params, opt, met = step_fn(params, opt, batch)
            if calls:
                routes.append(by_layer(calls, config))
            losses.append(float(met["loss"]))
            ctx.log(f"set-up step {i + 1}: loss {losses[-1]:.6f}")
            if i == 0:
                m = weights.program_leaves(model, opt.m)
                gnorm = {k: float(v.norm()) / (1 - b1) for k, v in m.items()}
                gdir = sketch(m, 1 / (1 - b1))
                del m
        dnorm = _change_norms(model, ctx.seed, dev, params)
        rec = window(ctx, step_fn, params, opt, pipe, B, S)
    finally:
        pipe.close()
    ctx.log(f"window: {len(rec['step_ends'])} steps in "
            f"{rec['step_ends'][-1]:.2f} s")
    rec["peak_bytes"] = max(rec["setup_peak_bytes"],
                            rec["peak_window_bytes"])
    del params, opt, trainer, step_fn
    gc.collect()
    if dev == "cuda":
        torch.cuda.empty_cache()
    prog = {"loss": losses, "grad": gnorm, "change": dnorm, "dir": gdir}
    rec["check"] = check(ctx, prog, batches, routes or None)
    return rec


def by_layer(calls: List[torch.Tensor], config: dict) -> list:
    """One step's recorded choices, in call order microbatch by
    microbatch and layer by layer, as [B, S, k] per layer; ``None`` for
    each layer where the calls are not one per layer and microbatch."""
    L = config["model"]["num_hidden_layers"]
    M = config["train"]["microbatches"]
    if len(calls) != L * M:
        return [None] * L
    return [torch.cat(calls[i::L], dim=0) for i in range(L)]


@torch.no_grad()
def _change_norms(model, seed, dev, params) -> Dict[str, float]:
    now = weights.program_leaves(model, params)
    return {k: float((now[k].float() - w0.float()).norm())
            for k, w0 in weights.leaves(model, seed, dev)}


def window(ctx, step_fn, params, opt, pipe, B, S) -> dict:
    job = ctx.traffic
    sync = torch.cuda.synchronize if ctx.device == "cuda" else (lambda: None)
    sl = tr.Slice() if ctx.trace else None
    calls: List[tuple] = []
    spans = []
    if ctx.trace:
        from repro_torch.optim import adamw
        from repro_torch.train import train_step

        spans = [tr.patched(train_step, "value_and_grad", "fwd_bwd"),
                 tr.patched(train_step, "lm_loss", "forward"),
                 tr.patched(adamw, "update", "optimizer")]
        for cm in spans:
            cm.__enter__()
    sync()
    setup_peak = 0
    if ctx.device == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    launches0 = port.launches()
    t0 = time.perf_counter()
    ctx.window_open = t0
    ends = []
    untraced = []  # seconds of each step the profiler did not slow
    in_slice = {}
    try:
        while True:
            batch = next(pipe)
            on = sl is not None and len(ends) == job["slice_step"]
            if on:
                sl.start()
                cm = port.record_calls(calls)
                cm.__enter__()
                before = port.launches()
            start = time.perf_counter() - t0
            with tr.span("step"):
                params, opt, _ = step_fn(params, opt, batch)
            sync()
            ends.append(time.perf_counter() - t0)
            if on:
                after = port.launches()
                cm.__exit__(None, None, None)
                sl.stop()
                in_slice = {k: after[k] - before[k] for k in after}
            else:
                untraced.append(ends[-1] - start)
            if ends[-1] >= ctx.seconds:
                break
    finally:
        for cm in spans:
            cm.__exit__(None, None, None)
    return {
        "kind": "train", "seconds": ctx.seconds, "model": ctx.config["model"],
        "batch": B, "seq": S, "step_ends": ends, "launches": (
            launches0, port.launches()),
        "trace": sl.summary if sl is not None else None, "calls": calls,
        "untraced_step_s": untraced,
        "launches_slice": in_slice,
        "peak_window_bytes": (torch.cuda.max_memory_allocated()
                              if ctx.device == "cuda" else 0),
        "setup_peak_bytes": setup_peak,
    }


def reference_run(ctx, batches, *, lowp=False, half=False,
                  routes=None) -> dict:
    """The reference's readings over the same steps: losses, each leaf's
    clipped first gradient norm and its change after the steps.  ``half``
    is the fault of a step that leaves out half of each batch and takes
    the mean over the rest.  In a mixture of experts the reference
    follows ``routes`` (per step, per layer) where given, and reads
    ``route_gap``; otherwise it keeps its own choices under ``routes``."""
    from .reference import adamw as ref_adamw
    from .reference import internlm2 as base
    from .reference import module

    config = ctx.config
    model = config["model"]
    ref = module(config["reference"])
    base.no_tf32()
    c = config["train"]["adamw"]
    p = {k: v.float().requires_grad_(True)
         for k, v in weights.leaves(model, ctx.seed, ctx.device)}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, gnorm, gdir = [], {}, {}
    routed = hasattr(ref, "Routes")
    gap, chosen = 0.0, []
    for t, batch in enumerate(batches, start=1):
        tok = batch["tokens"].to(ctx.device)
        lab = batch["labels"].to(ctx.device)
        given = routes[t - 1] if routes is not None else None
        if half:
            tok, lab = tok[: tok.shape[0] // 2], lab[: lab.shape[0] // 2]
            if given is not None:
                given = [r if r is None else r[: r.shape[0] // 2]
                         for r in given]
        ffn = ref.FFN
        if routed:
            step_routes = ref.Routes(given)
            ffn = functools.partial(ref.FFN, routes=step_routes)
        with torch.enable_grad():
            loss = base.loss(model, p, tok, lab, ffn=ffn, lowp=lowp,
                             remat=True)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        losses.append(float(loss.detach()))
        del loss
        if ctx.device == "cuda":
            torch.cuda.empty_cache()  # the activations' blocks, for AdamW
        raw = sketch(grads, 1.0) if t == 1 else None
        clipped, scale = ref_adamw.step(c, p, grads, m, v, t)
        del grads
        if routed:
            gap = max(gap, step_routes.gap)
            chosen.append([step_routes.chosen[i] for i in
                           range(model["num_hidden_layers"])]
                          if given is None else None)
        if t == 1:
            gnorm = clipped
            gdir = {k: [x * scale for x in xs] for k, xs in raw.items()}
    del m, v
    with torch.no_grad():
        dnorm = {k: float((p[k] - w0.float()).norm())
                 for k, w0 in weights.leaves(model, ctx.seed, ctx.device)}
    del p
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    out = {"loss": losses, "grad": gnorm, "change": dnorm, "dir": gdir}
    if routed and routes is not None:
        out["route_gap"] = gap
    if routed and routes is None:
        out["routes"] = chosen
    return out


def compare(got: dict, ref: dict) -> dict:
    """The numbers compared: the largest relative gap of a step's loss,
    and by the worst leaf the gap between the two norms of its first
    gradient and of its change, over the reference's norm of that leaf or
    of the median leaf, whichever is larger.  Leaves whose reference
    gradient is under a thousandth of the median leaf's are left out of
    the change.  ``grad_dir_gap`` and ``grad_dir_min_gap``: the median
    and the least leaf's relative distance between the two first
    gradients, read through their sketches."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], ref["loss"]))

    def worst(key, keep):
        med = sorted(ref[key][k] for k in keep)[len(keep) // 2]
        return max(abs(got[key][k] - ref[key][k]) / max(ref[key][k], med)
                   for k in keep)

    leaves = list(ref["grad"])
    g_med = sorted(ref["grad"].values())[len(leaves) // 2]
    moved = [k for k in leaves if ref["grad"][k] >= 1e-3 * g_med]
    dirs = sorted(math.dist(got["dir"][k], ref["dir"][k])
                  / math.hypot(*ref["dir"][k]) for k in leaves)
    return {"loss_gap": loss, "grad_norm_gap": worst("grad", leaves),
            "change_norm_gap": worst("change", moved),
            "grad_dir_gap": dirs[len(dirs) // 2],
            "grad_dir_min_gap": dirs[0],
            "left_out": sorted(set(leaves) - set(moved))}


def judged(got: dict, ref: dict) -> dict:
    """``compare``, and the widest gap of the judged side's expert
    choices where the reference followed them."""
    out = compare(got, ref)
    if "route_gap" in ref:
        out["route_gap"] = ref["route_gap"]
    return out


def check(ctx, prog: dict, batches, routes=None) -> dict:
    """The program against the reference that follows its choices of
    experts; with ``ctx.control`` also the control (the reference in
    float8, choosing its own experts) against a reference that follows
    those, and the fault of half of each batch left out, in the
    program's place and on its choices."""
    ref = reference_run(ctx, batches, routes=routes)
    ctx.log("reference run")
    out = judged(prog, ref)
    out["program"] = prog
    out["reference"] = {k: v for k, v in ref.items() if k != "routes"}
    if ctx.control:
        ctl = reference_run(ctx, batches, lowp=True)
        judge = ref
        if routes is not None:
            judge = reference_run(ctx, batches, routes=ctl.pop("routes"))
        out["control"] = judged(ctl, judge)
        out["fault_half_batch"] = compare(
            reference_run(ctx, batches, half=True, routes=routes), ref)
    return out
