"""The one traffic generator: a mix file of parameters in, requests out.

Serving mixes are open loops: each request has a due time in seconds
from the start of the run's traffic, whether or not earlier requests
have finished.  The sizes (group, prompt and output lengths) and the
gaps between arrivals are drawn once from the mix's ``shape_seed``, so
every run seed serves the same multiset of sizes and gaps; the run seed
only orders them, within blocks of ``shuffle_block`` consecutive
requests (so that every stretch of the run holds the same mix of sizes
and the same arrivals, whatever the seed), and draws the token ids.  Lengths are drawn from
``lognormal`` (``median``, ``sigma``) or ``loguniform`` distributions,
clipped to ``[min, max]``.  A group may give ``tenants`` clients, and a
``shared_prefix`` of ``tokens`` that the first ``tenants`` of them put
before every prompt long enough to hold it.

Arrivals are a Poisson process at ``rate_per_s``, or, with ``bursts``
(``period_s``, ``on_s``, ``factor``), that rate multiplied by ``factor``
inside each burst and lowered outside it so the mean stays the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Planned:
    """One request of a run: due time (s), client, lengths and tokens."""

    rid: str
    due: float
    group: str
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    shared: int = 0  # tokens of a shared system prompt at its start


def _draw(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    lo, hi = spec["min"], spec["max"]
    if spec["dist"] == "lognormal":
        x = np.exp(rng.normal(math.log(spec["median"]), spec["sigma"], n))
    elif spec["dist"] == "loguniform":
        x = np.exp(rng.uniform(math.log(lo), math.log(hi), n))
    elif spec["dist"] == "fixed":
        x = np.full(n, float(spec["value"]))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def shapes(mix: dict):
    """(group index, prompt length, output length) of ``mix["requests"]``
    requests and as many gaps between arrivals (s), from the mix's
    ``shape_seed`` alone."""
    rng = np.random.default_rng(mix["shape_seed"])
    n = mix["requests"]
    groups = mix["groups"]
    share = np.asarray([g["share"] for g in groups], np.float64)
    counts = np.floor(share / share.sum() * n).astype(np.int64)
    counts[0] += n - counts.sum()
    gidx = rng.permutation(np.repeat(np.arange(len(groups)), counts))
    prompt = np.empty(n, np.int64)
    output = np.empty(n, np.int64)
    for i, g in enumerate(groups):
        sel = gidx == i
        prompt[sel] = _draw(rng, g["prompt"], int(sel.sum()))
        output[sel] = _draw(rng, g["output"], int(sel.sum()))
    gaps = rng.exponential(1.0, n)  # unit-rate gaps, scaled per run
    return gidx, prompt, output, gaps


def _due_times(mix: dict, gaps: np.ndarray) -> np.ndarray:
    """Arrival times of unit-rate gaps at the mix's rate (and bursts): a
    time change of the unit-rate process by the rate's integral."""
    rate = float(mix["rate_per_s"])
    unit = np.cumsum(gaps)  # arrivals of a unit-rate process
    b = mix.get("bursts")
    if not b:
        return unit / rate
    period, on, factor = b["period_s"], b["on_s"], b["factor"]
    low = (period - factor * on) / (period - on)
    if low < 0:
        raise ValueError("bursts: factor * on_s exceeds period_s")
    # integral of the rate over one period, and the inverse within it
    per = rate * period
    k, rem = np.divmod(unit, per)
    hi = rate * factor * on
    t_in = np.where(rem < hi, rem / (rate * factor),
                    on + (rem - hi) / max(rate * low, 1e-12))
    return k * period + t_in


def _blockwise(rng: np.random.Generator, n: int, block: int) -> np.ndarray:
    """A permutation of range(n) that moves each index only within its
    block of ``block`` consecutive ones."""
    return np.concatenate([b0 + rng.permutation(min(block, n - b0))
                           for b0 in range(0, n, block)])


def plan(mix: dict, seed: int, vocab: int) -> List[Planned]:
    """Every request of one run, in order of due time."""
    gidx, prompt, output, gaps = shapes(mix)
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 0x5E7E])
    block = mix.get("shuffle_block", len(gidx))
    order = _blockwise(rng, len(gidx), block)
    gaps = gaps[_blockwise(rng, len(gaps), block)]
    due = _due_times(mix, gaps)
    groups = mix["groups"]
    prefixes = {}
    for gi, g in enumerate(groups):
        sp = g.get("shared_prefix")
        if sp:
            prefixes[gi] = rng.integers(0, vocab, sp["tokens"]).tolist()
    out = []
    for i, j in enumerate(order):
        g = groups[gidx[j]]
        tenant_i = int(rng.integers(0, g.get("tenants", 1)))
        tenant = (g["name"] if g.get("tenants", 1) == 1
                  else f"{g['name']}-{tenant_i}")
        n_prompt = int(prompt[j])
        pre = prefixes.get(int(gidx[j]), [])
        sp = g.get("shared_prefix") or {}
        shared = (len(pre) if pre and tenant_i < sp.get("tenants", 1)
                  and n_prompt >= len(pre) + sp.get("min_suffix", 1) else 0)
        toks = pre[:shared] + rng.integers(
            0, vocab, n_prompt - shared).tolist()
        out.append(Planned(f"r{i}", float(due[i]), g["name"], tenant, toks,
                           int(output[j]), shared))
    return out
