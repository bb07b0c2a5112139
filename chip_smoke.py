#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each printing one JSON line (or one per kernel or run):

1. ``device`` — the card as ``nvidia-smi`` names it, its power limit, and
   the torch/CUDA versions;
2. ``build`` — nvcc builds the three CUDA sources of
   ``src/repro_torch/kernels/csrc`` (one nvcc each, all at once);
3. ``kernel`` — each kernel against its plain PyTorch version on the card,
   in the working dtype, on inputs drawn from a seeded generator: K1/K2
   at the paged serving path's shapes (hd 128, page 16, 8 requests × 16
   heads, a table covering 1024 tokens) and a smoke shape; K3 (flash
   attention) at internlm2's first prompt chunk and full prompt, a gemma3
   local layer and a smoke shape; K4 (decode attention) at the
   chunked-prefill continuation, a dense batch, a gemma3 global layer and
   a windowed batch.  Kernel, plain-version and
   ``scaled_dot_product_attention`` times (cold L2), and the bound from
   the bytes and operations each call needs;
4. ``serve`` — internlm2-1.8b at full width (24 layers, d 2048, hd 128,
   vocab 92,544; random bf16 weights from a seed) served by the port's
   MURS engine over a paged KV pool sized to force suspensions, first
   through the paged-decode kernel, then (shorter) through its int8
   sibling.  Launch counters are zeroed just before each run and read
   just after: K1 (or K2) runs once per layer of each paged decode tick,
   K3 once per layer of each ``prefill``, K4 once per layer of each
   ``decode_step`` (the chunked-prefill continuation); every request must
   complete;
5. ``serve-gemma3`` — gemma3-1b at full width (26 layers, 5:1 local:global,
   window 512, d 1152, hd 256, one kv head, vocab 262,144, tied
   embeddings) through the same engine: every decode tick takes the
   dense path (K4 on the 4 global layers, the plain ring decode on the 22
   local ones) and every prefill runs K3 on all 26 layers;
6. ``reference`` — internlm2: one full-width decode step through K1
   against the dense step through K4 and the dense step of the plain
   versions on the same caches; gemma3: a 768-token prefill and 8 decode
   steps through K3/K4 against the same inside ``ops.plain_on_card``.

Then the ``kernels`` summary line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failed check exits 1.  Without a
CUDA device, or without the port's sources beside this file, it exits
non-zero and prints no result.
"""

import contextlib
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
#: gemma3's simulated HBM budget, in requests' worth of ring state
#: (11.5 MB each) — forces suspensions at 8 slots
GEMMA_POOL_STATES = 5.0
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


# (name, B, H, KV, Sq, Sk, hd, causal, window, q_offset): K3 at internlm2's
# first prompt chunk (the serve run's prefills are 32-65 tokens) and full
# prompt, a gemma3 local layer, and a smoke shape whose last two rows keep
# no key (positions 40, 41 against 37 keys, window 4)
FLASH_CASES = [
    ("internlm2_chunk", 1, 16, 8, 64, 64, 128, True, 0, 0),
    ("internlm2_prompt", 1, 16, 8, 1024, 1024, 128, True, 0, 0),
    ("gemma3_local", 1, 4, 1, 1024, 1024, 256, True, 512, 0),
    ("smoke", 1, 4, 2, 37, 37, 16, True, 4, 5),
]
# (name, B, H, KV, S, hd, window, positions): K4 at the chunked-prefill
# continuation, a dense batch of 8 slots, a gemma3 global layer, the batch
# with a window of 512; None draws the positions in [0, S)
DECODE_CASES = [
    ("continuation", 1, 16, 8, 1024, 128, 0, [199]),
    ("dense_batch", 8, 16, 8, 1024, 128, 0, None),
    ("gemma3_global", 8, 4, 1, 1024, 256, 0, None),
    ("window_batch", 8, 16, 8, 1024, 128, 512, None),
]
#: the case whose numbers go into the kernels line: the shape the
#: internlm2 serve run gives each kernel most often
LINE_CASE = {"flash_attention": "internlm2_chunk",
             "decode_attention": "continuation"}


def kept_pairs(sq, sk, causal, window, q_offset):
    """(query, key) pairs the mask keeps, and the rows that keep none."""
    pairs = empty = 0
    for i in range(sq):
        qp = q_offset + i
        lo = max(0, qp - window + 1) if window else 0
        hi = min(qp, sk - 1) if causal else sk - 1
        pairs += max(0, hi - lo + 1)
        empty += hi < lo
    return pairs, empty


def bound(n_bytes, flops, dtype, torch):
    """The least time (ms) for the bytes at HBM bandwidth and the
    operations at the dtype's peak, and which of the two binds."""
    from repro_torch.roofline.analysis import (
        FP32_PEAK_FLOPS, HBM_BW, PEAK_FLOPS,
    )

    peak = PEAK_FLOPS if dtype == torch.bfloat16 else FP32_PEAK_FLOPS
    bytes_s, ops_s = n_bytes / HBM_BW, flops / peak
    return 1e3 * max(bytes_s, ops_s), ("bytes" if bytes_s >= ops_s
                                       else "operations")


def attention_kernel_phase(torch, F, ref, flush):
    """K3 and K4 against their plain versions in bf16 (the smoke shapes in
    f32 too) at FLASH_CASES / DECODE_CASES; returns the kernels-line
    entries, from LINE_CASE."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)

    def rand(dtype, *shape):
        return torch.randn(*shape, generator=gen, device=DEV).to(dtype)

    results = {}
    for name, b, h, kv, sq, sk, hd, causal, window, q_offset in FLASH_CASES:
        for dtype in ((torch.float32, torch.bfloat16) if name == "smoke"
                      else (torch.bfloat16,)):
            q = rand(dtype, b, h, sq, hd)
            k = rand(dtype, b, kv, sk, hd)
            # v as the model holds it: a transposed view of [B, Sk, KV, hd]
            v = rand(dtype, b, sk, kv, hd).transpose(1, 2)
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            out = flash_attention(q, k, v, **kw)
            gold = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (out.float() - gold.float()).abs().max().item()
            atol = F32_ATOL if dtype == torch.float32 else bf16_ulp(gold)
            check(torch.isfinite(out.float()).all().item(),
                  f"flash_attention {name} {dtype}: non-finite output")
            check(err <= atol, f"flash_attention {name} {dtype}: max err "
                  f"{err} > {atol}")
            if dtype != torch.bfloat16:
                continue
            pairs, empty = kept_pairs(sq, sk, causal, window, q_offset)
            n_bytes = 2 * (2 * b * h * sq * hd + 2 * b * kv * sk * hd)
            flops = 4 * hd * b * h * pairs
            bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
            # yardstick: one SDPA call on KV repeated to the q heads
            kr = ref.repeat_kv(k, h // kv)
            vr = ref.repeat_kv(v, h // kv)
            qpos = q_offset + torch.arange(sq, device=DEV)[:, None]
            kpos = torch.arange(sk, device=DEV)[None, :]
            mask = (kpos <= qpos) if causal else torch.ones_like(qpos - kpos,
                                                                 dtype=bool)
            if window:
                mask = mask & (qpos - kpos < window)
            r = {
                "phase": "kernel", "name": "flash_attention", "case": name,
                "shape": {"B": b, "H": h, "KV": kv, "Sq": sq, "Sk": sk,
                          "hd": hd, "causal": causal, "window": window,
                          "q_offset": q_offset},
                "kept_pairs": pairs, "rows_without_key": empty,
                "max_abs_err": err, "tolerance_bf16": atol,
                "ms": time_ms(torch, lambda: flash_attention(q, k, v, **kw),
                              flush),
                "plain_ms": time_ms(
                    torch, lambda: ref.flash_attention_ref(q, k, v, **kw),
                    flush),
                "library_ms": time_ms(
                    torch, lambda: F.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask), flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bytes": n_bytes, "flops": flops,
            }
            emit(r)
            results[("flash_attention", name)] = r
    for name, b, h, kv, s, hd, window, positions in DECODE_CASES:
        dtype = torch.bfloat16
        q = rand(dtype, b, h, hd)
        # k, v: layer views of a [2, n_slots, KV, S, hd] cache, as the
        # engine's caches hand them to the model
        cache = rand(dtype, 2, b, kv, s, hd)
        k, v = cache[0], cache[1]
        pos = (torch.as_tensor(positions, dtype=torch.int32, device=DEV)
               if positions is not None else
               torch.randint(0, s, (b,), generator=gen, device=DEV,
                             dtype=torch.int32))
        out = decode_attention(q, k, v, pos, window=window)
        gold = ref.decode_attention_ref(q, k, v, pos, window=window)
        torch.cuda.synchronize()
        err = (out.float() - gold.float()).abs().max().item()
        atol = bf16_ulp(gold)
        check(torch.isfinite(out.float()).all().item(),
              f"decode_attention {name}: non-finite output")
        check(err <= atol, f"decode_attention {name}: max err {err} > {atol}")
        p = pos.cpu().tolist()
        kept = [min(c, s - 1) - (max(0, c - window + 1) if window else 0) + 1
                for c in p]
        n_bytes = (2 * 2 * kv * hd * sum(kept)
                   + 2 * 2 * b * h * hd + 4 * b)
        flops = 4 * hd * h * sum(kept)
        bound_ms, bound_by = bound(n_bytes, flops, dtype, torch)
        kpos = torch.arange(s, device=DEV)[None, :]
        mask = kpos <= pos[:, None].long()
        if window:
            mask = mask & (kpos > pos[:, None].long() - window)
        mask = mask[:, None, None, :]
        q4 = q[:, :, None, :]
        kr, vr = ref.repeat_kv(k, h // kv), ref.repeat_kv(v, h // kv)
        r = {
            "phase": "kernel", "name": "decode_attention", "case": name,
            "shape": {"B": b, "H": h, "KV": kv, "S": s, "hd": hd,
                      "window": window},
            "positions": p, "kept_keys": sum(kept),
            "max_abs_err": err, "tolerance_bf16": atol,
            "ms": time_ms(torch, lambda: decode_attention(
                q, k, v, pos, window=window), flush),
            "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(
                q, k, v, pos, window=window), flush),
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, kr, vr, attn_mask=mask), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": n_bytes, "flops": flops,
        }
        emit(r)
        results[("decode_attention", name)] = r
    return {kernel: {**results[(kernel, case)], "max_abs_err": max(
                r["max_abs_err"] for (kn, _), r in results.items()
                if kn == kernel)}
            for kernel, case in LINE_CASE.items()}


def count_calls(module, names):
    """Wrap ``module``'s functions ``names`` so that each call adds one to
    its entry of the returned dict (the engine calls the model through
    these names)."""
    counts = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(module, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)

        setattr(module, name, wrapped)
    return counts


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
    """Submit on schedule and step until drained; per tick (host ms,
    produced a token, ran a chunked-prefill continuation)."""
    ticks = []

    def tokens():
        return sum(len(r.generated) for r in eng.requests.values())

    while (eng.has_pending or sched) and eng.tick < 5000:
        for r in sched.pop(eng.tick, []):
            eng.submit(r)
        tokens0 = tokens()
        chunked0 = eng.chunked_prefill_ticks
        s = time.perf_counter()
        eng.step()
        ticks.append((1e3 * (time.perf_counter() - s), tokens() > tokens0,
                      eng.chunked_prefill_ticks > chunked0))
    return ticks


def serve_run(torch, cfg, params, tenants, int8, ops, calls):
    eng, sched = serve_engine(cfg, params, tenants, int8)
    out, eng = run_and_count(torch, cfg, eng, sched, ops, calls,
                             {"int8": int8, "tenants": tenants})
    kernel = ("paged_decode_attention_int8" if int8
              else "paged_decode_attention")
    ticks = eng.paged_int8_ticks if int8 else eng.paged_decode_ticks
    check(ticks > 0, f"serve int8={int8}: no paged decode tick")
    check(out["launches"][kernel] == cfg.n_layers * ticks,
          f"{kernel}: {out['launches'][kernel]} launches != "
          f"{cfg.n_layers} layers x {ticks} ticks")
    return out


def run_and_count(torch, cfg, eng, sched, ops, calls, extra, phase="serve"):
    """Drive ``eng`` with launch and call counters zeroed just before and
    read just after; emit the run's line and check that every request
    completed and that K3 and K4 ran once per attention layer of every
    ``prefill`` and ``decode_step`` call."""
    submitted = sum(len(v) for v in sched.values())
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path's counts start here
    calls.update(dict.fromkeys(calls, 0))
    t0 = time.perf_counter()
    ticks = drive(eng, sched)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    rep = eng.report()
    decode_only = [ms for ms, dec, chk in ticks if dec and not chk]
    n_full = sum(bt == "attn" for bt in cfg.block_pattern) * \
        cfg.resolved_pattern_repeats + sum(bt == "attn"
                                           for bt in cfg.suffix_blocks)
    out = {
        "phase": phase, "arch": cfg.name, **extra,
        "submitted": submitted, "completed": rep.completed,
        "failed": rep.failed, "suspensions": eng.suspensions,
        "prefix_hits": eng.prefix_hits, "ticks": eng.tick,
        "paged_decode_ticks": eng.paged_decode_ticks,
        "paged_int8_ticks": eng.paged_int8_ticks,
        "chunked_prefill_ticks": eng.chunked_prefill_ticks,
        "swap_outs": eng.swap_outs,
        "tokens_generated": rep.tokens_generated,
        "wall_s": wall, "tokens_per_s": rep.tokens_generated / wall,
        "median_token_tick_ms": statistics.median(
            ms for ms, dec, _ in ticks if dec),
        "median_decode_only_tick_ms": (
            statistics.median(decode_only) if decode_only else None),
        "s_in_chunked_prefill_ticks": sum(
            ms for ms, _, chk in ticks if chk) / 1e3,
        "s_in_other_ticks": sum(
            ms for ms, _, chk in ticks if not chk) / 1e3,
        "model_calls": dict(calls),
        "launches": launches,
        "n_slots": N_SLOTS, "max_seq": MAX_SEQ,
        "hbm_capacity_bytes": eng.ecfg.hbm_capacity_bytes,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    emit(out)
    check(rep.completed == submitted and rep.failed == 0,
          f"{phase} {extra}: {rep.completed}/{submitted} completed, "
          f"{rep.failed} failed")
    for rid, req in eng.requests.items():
        check(len(req.generated) == req.max_new_tokens
              and all(0 <= t < cfg.vocab for t in req.generated),
              f"{phase}: {rid} produced malformed tokens")
    check(calls["prefill"] > 0, f"{phase}: no prefill call")
    check(launches["flash_attention"] == cfg.n_layers * calls["prefill"],
          f"flash_attention: {launches['flash_attention']} launches != "
          f"{cfg.n_layers} layers x {calls['prefill']} prefill calls")
    check(launches["decode_attention"] == n_full * calls["decode_step"],
          f"decode_attention: {launches['decode_attention']} launches != "
          f"{n_full} full-attention layers x {calls['decode_step']} "
          "decode_step calls")
    return out, eng


# --------------------------------------------------------------- gemma3
def gemma3_traffic(Request, vocab, rng):
    """A — 2 × (768-token prompt, 32 new), A0 at tick 1 and A1 at tick 2,
    each prefilled in one K3 call whose window mask cuts; B — 4 × (48, 16)
    at tick 0; C — 3 × (64-token shared prefix + 1 token, 16 new), C0 at
    tick 0, C1 and C2 at tick 3."""
    sched = {}

    def at(tick, req):
        sched.setdefault(tick, []).append(req)

    for i in range(2):
        at(1 + i, Request(f"A{i}", "A", rng.integers(0, vocab, 768).tolist(),
                          32))
    for i in range(4):
        at(0, Request(f"B{i}", "B", rng.integers(0, vocab, 48).tolist(), 16))
    shared = rng.integers(0, vocab, 64).tolist()
    for i in range(3):
        at(0 if i == 0 else 3,
           Request(f"C{i}", "C", shared + [int(rng.integers(0, vocab))], 16))
    return sched


def gemma3_engine(cfg, params, device):
    """gemma3's engine and arrival schedule: MURS, 8 slots, max_seq 1024,
    page 16, prefix cache on, a 1024-token prefill budget, and an HBM
    budget of GEMMA_POOL_STATES requests' ring state."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, Request, ServingEngine

    eng = ServingEngine(
        cfg, params,
        EngineConfig(
            n_slots=N_SLOTS, max_seq=MAX_SEQ,
            hbm_capacity_bytes=GEMMA_POOL_STATES * cfg.constant_state_bytes(),
            policy=MursPolicy(MursConfig.for_serving(period=1.0)),
            prefix_cache=True, prefill_chunk_tokens=1024, device=device,
        ),
    )
    return eng, gemma3_traffic(Request, cfg.vocab,
                               np.random.default_rng(SEED))


def serve_gemma3(torch, cfg, params, ops, calls):
    eng, sched = gemma3_engine(cfg, params, DEV)
    out, eng = run_and_count(torch, cfg, eng, sched, ops, calls, {},
                             phase="serve-gemma3")
    check(out["suspensions"] >= 1, "serve-gemma3: no suspension")
    check(out["launches"]["paged_decode_attention"] == 0,
          "serve-gemma3: the paged kernel ran on a sliding-window model")
    check(calls["decode_step"] > 0, "serve-gemma3: no decode_step call")
    return out


def reference_phase(torch, cfg, params, ops):
    """One full-width decode step through K1 against the dense step
    through K4 and the dense step of the plain versions
    (``ops.plain_on_card``), on identical caches and batch shapes (3
    requests plus one pad row / idle slot): logits within LOGIT_ATOL."""
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
    def copy():
        return {"unit": {k: (a.clone(), b.clone())
                         for k, (a, b) in caches["unit"].items()},
                "suffix": []}

    dense, plain = copy(), copy()
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
    rows = torch.arange(len(lens), device=DEV)
    logits_d, _ = decode_step(cfg, params, tok, dense, poss, rows=rows)
    with unmoved_counters(ops, "reference"):
        logits_r, _ = decode_step(cfg, params, tok, plain, poss, rows=rows)
    torch.cuda.synchronize()
    a, b, r = (x[:3].float() for x in (logits_p, logits_d, logits_r))
    errs = {"paged_k1_vs_dense_k4": (a - b).abs().max().item(),
            "paged_k1_vs_dense_plain": (a - r).abs().max().item(),
            "dense_k4_vs_dense_plain": (b - r).abs().max().item()}
    out = {"phase": "reference", "arch": cfg.name, "rows": len(lens),
           "vocab": cfg.vocab, "shape": list(logits_p.shape),
           "max_abs_logit_diff": errs, "tolerance": LOGIT_ATOL,
           "argmax_equal": bool((a.argmax(-1) == r.argmax(-1)).all()
                                and (b.argmax(-1) == r.argmax(-1)).all())}
    emit(out)
    check(list(logits_p.shape) == [slots, 1, cfg.vocab], "reference: shape")
    check(torch.isfinite(a).all().item() and torch.isfinite(b).all().item(),
          "reference: non-finite logits")
    for what, err in errs.items():
        check(err <= LOGIT_ATOL, f"reference: {what} logits differ by {err}")


@contextlib.contextmanager
def unmoved_counters(ops, what):
    """Run a block inside ``ops.plain_on_card`` and check that no kernel
    launch counter moved in it."""
    before = [fn.launches for fn in ops.WRAPPERS]
    with ops.plain_on_card():
        yield
    check([fn.launches for fn in ops.WRAPPERS] == before,
          f"{what}: a kernel launched inside plain_on_card")


def reference_gemma3(torch, cfg, params, ops, prompt=768, steps=8):
    """gemma3 at full width: a ``prompt``-token prefill (past the window,
    so the local rings fold) and ``steps`` decode steps (the rings are
    already wrapped) through K3/K4, and the same inside
    ``ops.plain_on_card`` on the same parameters and tokens: logits of
    every step within LOGIT_ATOL."""
    from repro_torch.models import decode_step, prefill

    rng = np.random.default_rng(SEED + 3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, prompt + steps)),
                           device=DEV)
    poss = torch.arange(prompt, prompt + steps, dtype=torch.int32,
                        device=DEV)

    def run():
        logits, caches = prefill(cfg, params, toks[:, :prompt],
                                 max_seq=MAX_SEQ)
        out = [logits[:, -1]]
        for i in range(steps):
            logits, caches = decode_step(
                cfg, params, toks[:, prompt + i:prompt + i + 1], caches,
                poss[i:i + 1],
            )
            out.append(logits[:, 0])
        return torch.cat(out).float()

    ops.reset_launch_counts()
    kern = run()
    launches = {fn.__name__: fn.launches for fn in ops.WRAPPERS}
    with unmoved_counters(ops, "reference-gemma3"):
        plain = run()
    torch.cuda.synchronize()
    gap = (kern - plain).abs().amax(dim=-1)
    out = {"phase": "reference", "arch": cfg.name, "prompt": prompt,
           "decode_steps": steps,
           "max_abs_logit_diff": gap.max().item(),
           "per_step_max_abs_logit_diff": gap.tolist(),
           "tolerance": LOGIT_ATOL,
           "argmax_equal": (kern.argmax(-1) == plain.argmax(-1)).tolist(),
           "launches": launches}
    emit(out)
    check(torch.isfinite(kern).all().item(), "reference-gemma3: non-finite")
    check(launches["flash_attention"] == cfg.n_layers
          and launches["decode_attention"] == 4 * steps,
          f"reference-gemma3: launches {launches}")
    check(out["max_abs_logit_diff"] <= LOGIT_ATOL,
          f"reference-gemma3: logits differ by {out['max_abs_logit_diff']}")





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
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.models import init_model
    from repro_torch.serve import engine as engine_module

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    _build.build()  # one nvcc per source, all started together
    libs = [str(Path(_build.library(name)._name).relative_to(ROOT))
            for name in _build.SIGNATURES]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": libs})

    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=DEV)
    kres = kernel_phase(torch, F, pd, ref, flush)
    kres.update(attention_kernel_phase(torch, F, ref, flush))
    del flush

    # the engine calls the model through these names: count the calls
    calls = count_calls(engine_module, ("prefill", "decode_step"))

    cfg = ARCHS["internlm2-1.8b"]
    params = init_params(torch, cfg, init_model)
    f32 = serve_run(torch, cfg, params, ("A", "B", "C"), False, ops, calls)
    i8 = serve_run(torch, cfg, params, ("B", "C"), True, ops, calls)
    check(f32["suspensions"] > 0, "serve: the pool never forced a suspension")
    check(f32["prefix_hits"] > 0, "serve: no prefix-cache hit")
    check(f32["launches"]["decode_attention"] > 0,
          "serve: no chunked-prefill continuation through K4")
    reference_phase(torch, cfg, params, ops)
    del params
    torch.cuda.empty_cache()

    g_cfg = ARCHS["gemma3-1b"]
    g_params = init_params(torch, g_cfg, init_model)
    g3 = serve_gemma3(torch, g_cfg, g_params, ops, calls)
    reference_gemma3(torch, g_cfg, g_params, ops)

    replaces = {
        "paged_decode_attention": "src/repro/kernels/paged_decode.py:187",
        "paged_decode_attention_int8":
            "src/repro/kernels/paged_decode.py:132",
        "flash_attention": "src/repro/kernels/flash_attention.py:82",
        "decode_attention": "src/repro/kernels/decode_attention.py:71",
    }
    source = {
        "paged_decode_attention": "paged_decode.cu",
        "paged_decode_attention_int8": "paged_decode.cu",
        "flash_attention": "flash_attention.cu",
        "decode_attention": "decode_attention.cu",
    }
    # launches on the main path: the sum over the three serving runs,
    # each counted from zero
    runs = (f32, i8, g3)
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{source[name]}",
         "replaces": replaces[name],
         "launches": sum(run["launches"][name] for run in runs),
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


def init_params(torch, cfg, init_model):
    """Random bf16 parameters of ``cfg`` at full width from SEED."""
    t0 = time.perf_counter()
    params = init_model(cfg, SEED, device=DEV)
    torch.cuda.synchronize()
    emit({"phase": "init", "arch": cfg.name, "layers": cfg.n_layers,
          "d_model": cfg.d_model, "head_dim": cfg.head_dim,
          "kv_groups": cfg.n_heads // cfg.n_kv_heads, "vocab": cfg.vocab,
          "kv_bytes_per_token": cfg.kv_bytes_per_token(),
          "constant_state_bytes": cfg.constant_state_bytes(),
          "param_gib": sum(
              t.numel() * t.element_size() for t in _tensors(params)
          ) / 2**30,
          "seconds": time.perf_counter() - t0})
    return params


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
