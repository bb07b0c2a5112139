"""Everything the benchmark takes from the port (``repro_torch``): its
configuration object, its serving engine and trainer, its counters, and
the shapes of the kernel calls it makes, recorded at ``kernels.ops``.

Imported only after ``run.py`` has put the checkout's ``src`` on the
path; nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch

#: engine counters read at the window's edges
ENGINE_COUNTERS = ("suspensions", "swap_outs", "stall_ticks",
                   "transfer_stall_ticks", "prefix_hits", "prefix_hit_tokens",
                   "chunked_prefill_ticks", "paged_decode_ticks",
                   "reactive_offloads", "proactive_demotions")
#: the ops entries whose calls the traced slice records, by name
RECORDED_OPS = ("paged_decode_attention", "flash_attention",
                "decode_attention", "grouped_matmul")


def arch(config: dict):
    """The port's ArchConfig of ``config``, every shape and the norm's
    epsilon, RoPE's base and the MoE's capacity taken from the file."""
    from repro_torch.configs import get_arch

    m = config["model"]
    base = get_arch(config["port_arch"])
    moe = base.moe
    if moe is not None:
        moe = dataclasses.replace(
            moe, num_experts=m["num_local_experts"],
            top_k=m["num_experts_per_tok"],
            d_ff_expert=m["intermediate_size"],
            capacity_factor=m["capacity_factor"])
    return dataclasses.replace(
        base, n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"], n_kv_heads=m["num_key_value_heads"],
        d_ff=m["intermediate_size"], vocab=m["vocab_size"],
        d_head=m["head_dim"], rope_theta=float(m["rope_theta"]),
        norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m.get("tie_word_embeddings", False)), moe=moe,
        pattern_repeats=None)


def kv_bytes_per_token(model: dict) -> int:
    return (2 * model["num_hidden_layers"] * model["num_key_value_heads"]
            * model["head_dim"] * 2)


def engine(config: dict, cfg, params, device: str):
    """A ServingEngine under MursPolicy with the file's settings."""
    from repro_torch.sched import MursConfig, MursPolicy
    from repro_torch.serve import EngineConfig, ServingEngine

    s = config["serve"]
    return ServingEngine(cfg, params, EngineConfig(
        n_slots=s["n_slots"], max_seq=s["max_seq"],
        hbm_capacity_bytes=float(kv_bytes_per_token(config["model"])
                                 * s["pool_tokens"]),
        policy=MursPolicy(MursConfig.for_serving(period=s["murs_period"])),
        prefill_chunk_tokens=s["prefill_chunk_tokens"],
        offload_enabled=s["offload"], prefix_cache=s["prefix_cache"],
        paged_decode=s["paged_decode"],
        max_prefix_snapshots=s["max_prefix_snapshots"], device=device))


def request(p):
    from repro_torch.serve import Request

    return Request(p.rid, p.tenant, list(p.prompt), p.max_new_tokens)


def engine_counters(eng) -> Dict[str, int]:
    return {k: int(getattr(eng, k)) for k in ENGINE_COUNTERS}


def launches() -> Dict[str, int]:
    from repro_torch.kernels import ops

    return {fn.__name__: fn.launches for fn in ops.WRAPPERS}


def build_kernels() -> None:
    """Build (or find in the checkout's build cache) every CUDA source."""
    from repro_torch.kernels import _build

    _build.build()


@contextlib.contextmanager
def record_calls(calls: List[tuple]):
    """Record (op, shapes, extra) of every call of the recorded ``ops``
    entries, and a copy of paged decode's lengths, while inside."""
    from repro_torch.kernels import ops

    saved = {n: getattr(ops, n) for n in RECORDED_OPS}

    def wrap(name, fn):
        def rec(*args, **kwargs):
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            extra = dict(kwargs)
            if name == "paged_decode_attention":
                extra["lens"] = args[4].detach().clone()
            if name == "decode_attention":
                extra["pos"] = args[3].detach().clone()
            if name in ("flash_attention", "grouped_matmul"):
                extra["grad"] = torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad
                    for a in args)
            calls.append((name, shapes, extra))
            return fn(*args, **kwargs)
        return rec

    for n, fn in saved.items():
        setattr(ops, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(ops, n, fn)


@contextlib.contextmanager
def record_routes(out: List[torch.Tensor]):
    """Record, while inside, the experts each token went to at every MoE
    dispatch of a forward pass, read from what the dispatch returned:
    [G, N, k] per call in call order, each token's k experts in
    ascending order (the order within a token changes neither its
    weights nor any expert's queue).  The dispatch lists its entries by
    expert, each expert's kept entries before its dropped ones, so a
    dropped entry's expert is that of the last kept entry before it.
    The backward's recomputes of a layer are left out."""
    from repro_torch.models import blocks

    real = blocks.moe_dispatch_row

    def rec(x, gates, top_k, capacity):
        res = real(x, gates, top_k, capacity)
        if torch._C._current_graph_task_id() == -1:  # not in a backward
            _, slot, tok, _, keep = res
            known = torch.where(keep, slot // capacity, -1)
            expert = torch.cummax(known, dim=-1).values
            by_tok = torch.argsort(tok, dim=-1, stable=True)
            out.append(expert.gather(-1, by_tok).view(
                gates.shape[0], gates.shape[1], top_k).to(torch.uint8))
        return res

    blocks.moe_dispatch_row = rec
    try:
        yield out
    finally:
        blocks.moe_dispatch_row = real


def trainer(config: dict, cfg, batch: int, seq: int, device: str, seed: int,
            ckpt_dir: str):
    """A Trainer with the file's settings (no checkpoint within reach of
    a run) and its (params, opt_state, step function)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.configs.base import ShapeConfig

    t = config["train"]
    tcfg = TrainerConfig(steps=1 << 30, ckpt_dir=ckpt_dir,
                         ckpt_every=1 << 30, microbatches=t["microbatches"],
                         remat=t["remat"], seed=seed,
                         opt=AdamWConfig(**t["adamw"]), device=device)
    shape = ShapeConfig(f"b{batch}s{seq}", seq, batch, "train")
    return Trainer(cfg, shape, tcfg, batch=batch, seq=seq), shape


def pipeline(cfg, shape, seed: int, batch: int, seq: int, device: str):
    from repro_torch.data.pipeline import DataConfig, DataPipeline

    return DataPipeline(cfg, shape, DataConfig(seed=seed), batch=batch,
                        seq=seq, device=device)
