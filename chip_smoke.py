#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` — the card as ``nvidia-smi`` names it, its power limit, and
   the torch/CUDA versions;
2. ``build`` — nvcc builds the CUDA source of ``src/repro_torch/kernels``;
3. ``kernel`` — each kernel against its plain PyTorch version on the card
   at the serving path's shapes (hd 128, page 16, 8 requests × 16 heads, a
   table covering 1024 tokens) and at a smoke shape (hd 16, a zero-length
   row), in the working dtype, on inputs drawn from a seeded generator;
   kernel, plain-version and ``scaled_dot_product_attention`` times (cold
   L2), and the bound from the bytes and operations this batch needs;
4. ``serve`` — internlm2-1.8b at full width (24 layers, d 2048, hd 128,
   vocab 92,544; random bf16 weights from a seed) served by the port's
   MURS engine over a paged KV pool sized to force suspensions, first
   through the paged-decode kernel, then (shorter) through its int8
   sibling.  Launch counters are zeroed just before each run and read
   just after; every request must complete;
5. ``reference`` — one full-width decode step through the kernel against
   the dense plain-attention step on the same caches.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits 1.  Without a
CUDA device, or without the port's sources beside this file, it exits
non-zero and prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
DEV = "cuda"
N_SLOTS, MAX_SEQ, PAGE = 8, 1024, 16
POOL_PAGES = 48  # pool pages of the simulated HBM budget
F32_ATOL = 1e-5  # kernel vs plain in f32: summation order only
LOGIT_ATOL = 0.1  # full-width logits through two attention paths


class CheckFailed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
def time_ms(torch, fn, flush, iters=30):
    """Median device time of ``fn`` over ``iters`` launches, each after an
    L2-evicting write (the cache is 50 MB; ``flush`` is larger)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


# ----------------------------------------------------------------- kernels
def paged_case(torch, rng, *, reqs, heads, kv_heads, hd, page, width,
               dtype, zero_row=False):
    """A folded paged-decode batch as the engine builds it: each request's
    pages scattered over a pool, its table row repeated per q-head with
    the kv-head offset ``(h // G) * n_pool``."""
    n_pool = reqs * width
    perm = rng.permutation(n_pool).reshape(reqs, width)
    lens = rng.integers(1, width * page + 1, size=reqs)
    if zero_row:
        lens[-1] = 0
    hoff = np.arange(heads) // (heads // kv_heads)
    table = (perm[:, None, :] + hoff[None, :, None] * n_pool).reshape(
        reqs * heads, width
    )
    row_lens = lens.repeat(heads)
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(2**31)))
    draw = dict(device=DEV, generator=gen)
    q = torch.randn(reqs * heads, hd, **draw).to(dtype)
    k = torch.randn(kv_heads * n_pool, page, hd, **draw).to(dtype)
    v = torch.randn(kv_heads * n_pool, page, hd, **draw).to(dtype)
    t = torch.as_tensor(table, dtype=torch.int32, device=DEV)
    s = torch.as_tensor(row_lens, dtype=torch.int32, device=DEV)
    return q, k, v, t, s


def needed(table, lens, page):
    """What the batch needs the kernel to touch: the (row, page) table
    entries each row sweeps (``ceil(len / page)``, or all W pages for a
    zero-length pad row), the distinct pool pages among them, and the
    tokens attended over all rows."""
    pages = set()
    entries = tokens = 0
    tab = table.cpu().numpy()
    for r, n in enumerate(lens.cpu().numpy().tolist()):
        sweep = math.ceil(n / page) if n > 0 else tab.shape[1]
        pages.update(tab[r, :sweep].tolist())
        entries += sweep
        tokens += n if n > 0 else tab.shape[1] * page
    return entries, len(pages), tokens


def bf16_ulp(x):
    """One bf16 ulp (8 significant bits) at the largest |x|: two roundings
    to bf16 of f32 values that differ in summation order alone differ by
    at most this much."""
    return 2.0 ** (math.floor(math.log2(x.float().abs().max().item())) - 7)


def kernel_phase(torch, F, pd, ref, flush):
    """Compare and time both kernels; returns their summary entries."""
    from repro_torch.roofline.analysis import FP32_PEAK_FLOPS, HBM_BW

    rng = np.random.default_rng(SEED)
    results = {}
    for name, int8 in (("paged_decode_attention", False),
                       ("paged_decode_attention_int8", True)):
        max_err, max_tol = 0.0, 0.0
        for shape in ("smoke", "path"):
            for dtype in (torch.float32, torch.bfloat16):
                kw = (dict(reqs=4, heads=4, kv_heads=4, hd=16, page=16,
                           width=4, zero_row=True)
                      if shape == "smoke" else
                      dict(reqs=8, heads=16, kv_heads=8, hd=128, page=PAGE,
                           width=MAX_SEQ // PAGE))
                q, k, v, table, lens = paged_case(
                    torch, rng, dtype=dtype, **kw
                )
                if int8:
                    from repro_torch.models.transformer import (
                        _quantize_pool_int8,
                    )

                    kc, ks = _quantize_pool_int8(k)
                    vc, vs = _quantize_pool_int8(v)
                    args = (q, kc, vc, ks, vs, table, lens)
                    kern = pd.paged_decode_attention_int8
                    plain = ref.paged_decode_attention_int8_ref
                else:
                    args = (q, k, v, table, lens)
                    kern = pd.paged_decode_attention
                    plain = ref.paged_decode_attention_ref
                out = kern(*args)
                gold = plain(*args)
                torch.cuda.synchronize()
                err = (out.float() - gold.float()).abs().max().item()
                atol = (F32_ATOL if dtype == torch.float32
                        else bf16_ulp(gold))
                check(torch.isfinite(out.float()).all().item(),
                      f"{name} {shape} {dtype}: non-finite output")
                check(err <= atol, f"{name} {shape} {dtype}: max err {err}"
                      f" > {atol}")
                if shape != "path" or dtype != torch.bfloat16:
                    continue
                max_err, max_tol = max(max_err, err), max(max_tol, atol)
                entries, distinct, tokens = needed(table, lens, PAGE)
                # K and V of each distinct page, q in and out back (bf16),
                # the swept table entries, the lengths, and for int8 the
                # K and V scales of each distinct page
                elem = 1 if int8 else 2
                n_bytes = (distinct * 2 * PAGE * 128 * elem
                           + 2 * q.numel() * 2 + entries * 4
                           + lens.numel() * 4
                           + (2 * distinct * 4 if int8 else 0))
                bytes_s = n_bytes / HBM_BW
                ops_s = 4 * 128 * tokens / FP32_PEAK_FLOPS
                # library yardstick: SDPA over the gathered, masked KV
                bh, w = table.shape
                kg = (kc.float() * ks[:, None, None] if int8 else k)[
                    table.long()].reshape(bh, 1, w * PAGE, 128).to(q.dtype)
                vg = (vc.float() * vs[:, None, None] if int8 else v)[
                    table.long()].reshape(bh, 1, w * PAGE, 128).to(q.dtype)
                mask = (torch.arange(w * PAGE, device=DEV)[None, :]
                        < lens[:, None])[:, None, None, :]
                q4 = q[:, None, None, :]
                results[name] = {
                    "ms": time_ms(torch, lambda: kern(*args), flush),
                    "plain_ms": time_ms(torch, lambda: plain(*args), flush),
                    "library_ms": time_ms(
                        torch,
                        lambda: F.scaled_dot_product_attention(
                            q4, kg, vg, attn_mask=mask),
                        flush,
                    ),
                    "bound_ms": 1e3 * max(bytes_s, ops_s),
                    "bound_by": "bytes" if bytes_s >= ops_s else "operations",
                    "bytes": n_bytes,
                    "flops": 4 * 128 * tokens,
                }
        results[name]["max_abs_err"] = max_err
        emit({"phase": "kernel", "name": name, **results[name],
              "tolerance": {"f32": F32_ATOL, "bf16_path": max_tol}})
    return results


# ------------------------------------------------------------------- serve
def traffic(Request, vocab, rng):
    """Three tenants: A — 4 × 200-token prompts (chunked prefill), 64 new
    tokens; B — 4 × 32-token prompts, 16 new; C — 3 requests on one shared
    64-token prefix plus a distinct token, 16 new.  A arrives one tick
    after B and C0; C1 and C2 arrive at tick 3, after C0 published its
    prefix.  Returns {arrival tick: [requests]}."""
    sched = {}

    def at(tick, req):
        sched.setdefault(tick, []).append(req)

    for i in range(4):
        at(1, Request(f"A{i}", "A", rng.integers(0, vocab, 200).tolist(), 64))
    for i in range(4):
        at(0, Request(f"B{i}", "B", rng.integers(0, vocab, 32).tolist(), 16))
    shared = rng.integers(0, vocab, 64).tolist()
    for i in range(3):
        at(0 if i == 0 else 3,
           Request(f"C{i}", "C", shared + [int(rng.integers(0, vocab))], 16))
    return sched


def serve_engine(cfg, params, tenants, int8):
    """The engine under test and its arrival schedule for ``tenants``."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=cfg.kv_bytes_per_token() * PAGE * POOL_PAGES,
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, paged_decode_int8=int8, device=DEV,
        ),
    )
    sched = {
        t: [r for r in reqs if r.tenant in tenants]
        for t, reqs in traffic(Request, cfg.vocab,
                               np.random.default_rng(SEED)).items()
    }
    return eng, sched


def drive(eng, sched):
    """Submit on schedule and step until drained; per tick (host ms, ran
    a paged decode, ran a chunked-prefill continuation)."""
    ticks = []
    while (eng.has_pending or sched) and eng.tick < 5000:
        for r in sched.pop(eng.tick, []):
            eng.submit(r)
        decoded0 = eng.paged_decode_ticks
        chunked0 = eng.chunked_prefill_ticks
        s = time.perf_counter()
        eng.step()
        ticks.append((1e3 * (time.perf_counter() - s),
                      eng.paged_decode_ticks > decoded0,
                      eng.chunked_prefill_ticks > chunked0))
    return ticks


def serve_run(torch, cfg, params, tenants, int8, pd):
    eng, sched = serve_engine(cfg, params, tenants, int8)
    submitted = sum(len(v) for v in sched.values())
    torch.cuda.synchronize()
    pd.reset_launch_counts()  # the main path's counts start here
    t0 = time.perf_counter()
    ticks = drive(eng, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in pd.WRAPPERS}
    rep = eng.report()
    decode_only = [ms for ms, dec, chk in ticks if dec and not chk]
    out = {
        "phase": "serve", "int8": int8, "tenants": tenants,
        "submitted": submitted, "completed": rep.completed,
        "failed": rep.failed, "suspensions": eng.suspensions,
        "prefix_hits": eng.prefix_hits, "ticks": eng.tick,
        "paged_decode_ticks": eng.paged_decode_ticks,
        "paged_int8_ticks": eng.paged_int8_ticks,
        "chunked_prefill_ticks": eng.chunked_prefill_ticks,
        "swap_outs": eng.swap_outs,
        "tokens_generated": rep.tokens_generated,
        "wall_s": wall, "tokens_per_s": rep.tokens_generated / wall,
        "median_decode_tick_ms": statistics.median(
            ms for ms, dec, _ in ticks if dec),
        "median_decode_only_tick_ms": (
            statistics.median(decode_only) if decode_only else None),
        "s_in_chunked_prefill_ticks": sum(
            ms for ms, _, chk in ticks if chk) / 1e3,
        "s_in_other_ticks": sum(
            ms for ms, _, chk in ticks if not chk) / 1e3,
        "launches": launches,
        "pool_pages": POOL_PAGES, "n_slots": N_SLOTS, "max_seq": MAX_SEQ,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(rep.completed == submitted and rep.failed == 0,
          f"serve int8={int8}: {rep.completed}/{submitted} completed, "
          f"{rep.failed} failed")
    for rid, req in eng.requests.items():
        check(len(req.generated) == req.max_new_tokens
              and all(0 <= t < cfg.vocab for t in req.generated),
              f"serve: {rid} produced malformed tokens")
    kernel = ("paged_decode_attention_int8" if int8
              else "paged_decode_attention")
    ticks = eng.paged_int8_ticks if int8 else eng.paged_decode_ticks
    check(ticks > 0, f"serve int8={int8}: no paged decode tick")
    check(launches[kernel] == cfg.n_layers * ticks,
          f"{kernel}: {launches[kernel]} launches != "
          f"{cfg.n_layers} layers x {ticks} ticks")
    return out


def reference_phase(torch, cfg, params):
    """One full-width decode step through the kernel against the dense
    plain-attention step on identical caches and batch shapes (3 requests
    plus one pad row / idle slot): logits within LOGIT_ATOL."""
    from repro_torch.models import (
        decode_step, decode_step_paged, init_cache, prefill,
    )

    rng = np.random.default_rng(SEED + 1)
    lens, slots, max_seq = [40, 25, 17], 4, 64
    caches = init_cache(cfg, slots, max_seq, device=DEV)
    for s, n in enumerate(lens):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)),
                               device=DEV)
        _, c = prefill(cfg, params, toks, max_seq=max_seq)
        for (dk, dv), (pk, pv) in zip(caches["unit"].values(),
                                      c["unit"].values()):
            dk[:, s].copy_(pk[:, 0])
            dv[:, s].copy_(pv[:, 0])
    dense = {"unit": {k: (a.clone(), b.clone())
                      for k, (a, b) in caches["unit"].items()},
             "suffix": []}
    tables, src_slot, src_idx, pid = [], [], [], 0
    for s, n in enumerate(lens):
        row = list(range(pid, pid + n // PAGE + 1))
        src_slot += [s] * len(row)
        src_idx += list(range(len(row)))
        pid += len(row)
        tables.append(row)
    n_pool = 1 << (pid - 1).bit_length()
    w = 1 << (max(map(len, tables)) - 1).bit_length()
    tab = np.zeros((slots, w), np.int32)
    for r, row in enumerate(tables):
        tab[r, :len(row)] = row
    pad = n_pool - pid
    cuda = dict(dtype=torch.int32, device=DEV)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab, (slots, 1)), **cuda)
    poss = torch.as_tensor(lens + [0], **cuda)
    logits_p, _ = decode_step_paged(
        cfg, params, tok, caches, poss,
        torch.as_tensor([0, 1, 2, slots], **cuda),
        torch.as_tensor(tab, **cuda),
        torch.as_tensor([n + 1 for n in lens] + [0], **cuda),
        torch.as_tensor(src_slot + [0] * pad, **cuda),
        torch.as_tensor(src_idx + [0] * pad, **cuda),
        page_tokens=PAGE, n_pool=n_pool,
    )
    logits_d, _ = decode_step(
        cfg, params, tok, dense, poss,
        rows=torch.arange(len(lens), device=DEV),
    )
    torch.cuda.synchronize()
    a, b = logits_p[:3].float(), logits_d[:3].float()
    err = (a - b).abs().max().item()
    out = {"phase": "reference", "rows": len(lens), "vocab": cfg.vocab,
           "shape": list(logits_p.shape), "max_abs_logit_diff": err,
           "tolerance": LOGIT_ATOL,
           "argmax_equal": bool((a.argmax(-1) == b.argmax(-1)).all())}
    emit(out)
    check(list(logits_p.shape) == [slots, 1, cfg.vocab], "reference: shape")
    check(torch.isfinite(a).all().item(), "reference: non-finite logits")
    check(err <= LOGIT_ATOL, f"reference: logits differ by {err}")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 3
    # full-precision f32 matmuls (logits, plain versions): no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import init_model

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    lib = _build.library("paged_decode")
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(Path(lib._name).relative_to(ROOT))})

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEV)
    kres = kernel_phase(torch, F, pd, ref, flush)
    del flush

    cfg = ARCHS["internlm2-1.8b"]
    t0 = time.perf_counter()
    params = init_model(cfg, SEED, device=DEV)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "kv_groups": cfg.n_heads // cfg.n_kv_heads, "vocab": cfg.vocab,
          "kv_bytes_per_token": cfg.kv_bytes_per_token(),
          "param_gib": sum(
              t.numel() * t.element_size() for t in _tensors(params)
          ) / 2**30,
          "seconds": time.perf_counter() - t0})

    f32 = serve_run(torch, cfg, params, ("A", "B", "C"), False, pd)
    i8 = serve_run(torch, cfg, params, ("B", "C"), True, pd)
    check(f32["suspensions"] > 0, "serve: the pool never forced a suspension")
    check(f32["prefix_hits"] > 0, "serve: no prefix-cache hit")
    reference_phase(torch, cfg, params)

    replaces = {
        "paged_decode_attention": "src/repro/kernels/paged_decode.py:187",
        "paged_decode_attention_int8":
            "src/repro/kernels/paged_decode.py:132",
    }
    launches = {
        "paged_decode_attention": f32["launches"]["paged_decode_attention"],
        "paged_decode_attention_int8":
            i8["launches"]["paged_decode_attention_int8"],
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
         "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for name, r in kres.items()
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
