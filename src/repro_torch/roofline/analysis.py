"""Roofline analysis on an NVIDIA H100: the dry-run cells and the
serving engine's tick cost.

Per (arch × shape × mesh) cell, from the port's dry-run record
(``repro_torch.launch.dryrun``):

    compute    = analytic useful FLOPs (remat-adjusted) / chips / peak
    memory     = analytic HBM traffic / chips / HBM bandwidth
    collective = Σ over mesh axes of that axis's collective bytes per
                 device / the rate of the link its groups cross

MODEL_FLOPS uses 6·N·T (train) / 2·N·T (inference) with N = active
params, plus the causal-attention term; the ratio MODEL_FLOPS / (traced
FLOPs × chips) measures how much of the traced step's compute is
"useful" (remat recompute, dispatch overheads and padding show up
here).  The traced FLOPs are those of the per-device program on fake
tensors (``repro_torch.launch.dryrun``), counted, not measured.

Links.  One HGX H100 node joins 8 cards by NVLink 4: 450 GB/s each way
a card (NVIDIA's H100 data sheet: 900 GB/s both ways).  Nodes are joined
by InfiniBand: 8 ConnectX-7 NDR ports a node, 400 Gb/s = 50 GB/s each
way a card (NVIDIA's DGX H100 reference architecture).  Ranks are laid
out on nodes in mesh order (the last mesh axis fastest), 8 to a node, so
a collective over mesh axis i stays on NVLink only where its group's
ranks, ``size_i`` of them ``stride_i`` apart (the product of the later
axes' sizes), fall in one node: ``(size_i - 1) * stride_i < 8``.  On
the 16×16 and 2×16×16 meshes every axis crosses nodes.  A record's
collectives carry their bytes by mesh axis (``axes``) and the mesh's
axes and sizes (``mesh_axes``); a record without them (or a record of
another package) prices all its bytes at NVLink's rate.  A record with
``null`` collectives has no collective term: "–", and the bottleneck
and step time use the terms that exist.

The constants are the H100 SXM part's (NVIDIA's data sheet, dense rates
without sparsity, 700 W): ``nvidia-smi`` names it "NVIDIA H100 80GB
HBM3".  The PCIe part is slower on every term (756 TFLOP/s bf16,
2.0 TB/s) and is not what these numbers describe.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..configs import ARCHS, SHAPES

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
FP32_PEAK_FLOPS = 67e12  # f32 FLOP/s on the CUDA cores, outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
PCIE_BW = 64e9  # bytes/s host link, PCIe Gen5 x16 — KV offload/promote path
NVLINK_BW = 450e9  # bytes/s each way, NVLink 4 (900 GB/s both ways)
IB_BW = 50e9  # bytes/s each way a card, one 400 Gb/s NDR port a card
NODE_CARDS = 8  # cards an HGX H100 node joins by NVLink

CHIPS = {"16x16": 256, "2x16x16": 512}


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole step (global, all chips)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    b, s = shape.global_batch, shape.seq_len

    counts: Dict[str, int] = {}
    for blk in (
        list(cfg.block_pattern) * cfg.resolved_pattern_repeats
        + list(cfg.suffix_blocks)
    ):
        counts[blk] = counts.get(blk, 0) + 1
    full_attn = counts.get("attn", 0) + counts.get("shared_attn", 0)
    local_attn = counts.get("local_attn", 0)
    qk_dim = cfg.n_heads * cfg.head_dim if cfg.n_heads else 0

    if shape.kind == "train":
        tokens = b * s
        flops = 6.0 * n_active * tokens
        # causal attention: fwd 2·(QK+PV)·0.5, bwd ×2 → 6·S²·qk·0.5
        flops += 6.0 * full_attn * b * s * s * qk_dim
        flops += 6.0 * local_attn * b * s * min(s, cfg.sliding_window) * qk_dim
        return flops
    if shape.kind == "prefill":
        tokens = b * s
        flops = 2.0 * n_active * tokens
        flops += 2.0 * full_attn * b * s * s * qk_dim
        flops += 2.0 * local_attn * b * s * min(s, cfg.sliding_window) * qk_dim
        return flops
    # decode: one token over a seq_len cache
    flops = 2.0 * n_active * b
    flops += 4.0 * full_attn * b * s * qk_dim  # QK + PV over the cache
    flops += 4.0 * local_attn * b * min(s, cfg.sliding_window) * qk_dim
    if cfg.ssm is not None and counts.get("mamba"):
        ssm = cfg.ssm
        flops += (
            4.0 * counts["mamba"] * b
            * ssm.n_heads(cfg.d_model) * ssm.head_dim * ssm.d_state
        )
    return flops


def memory_traffic_bytes(arch: str, shape_name: str) -> float:
    """Analytic minimum HBM traffic per step (global bytes):

      decode : weights once per step + whole KV cache + constant states
      prefill: weights + KV written + activations (8 B/elem/layer envelope)
      train  : params+opt traffic (20·N: bf16 p r/w, f32 m,v r/w, grads)
               + activations 24 B/elem/layer (fwd save + bwd touch, bf16)
    """
    from ..serve.kv_cache import constant_state_bytes, kv_bytes_per_token

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    b, s = shape.global_batch, shape.seq_len
    n_total = cfg.param_count()
    n_active = cfg.active_param_count()
    kv_tok = kv_bytes_per_token(cfg)
    states = constant_state_bytes(cfg)
    d, L = cfg.d_model, cfg.n_layers

    if shape.kind == "decode":
        weights = 2.0 * n_total  # bf16; all experts touched at batch≥128
        kv = b * (kv_tok * s + states)
        acts = b * L * d * 24.0
        return weights + kv + acts
    if shape.kind == "prefill":
        tokens = b * s
        weights = 2.0 * n_active  # streamed once (batched)
        kv_write = b * (kv_tok * s + states)
        acts = tokens * L * d * 8.0
        return weights + kv_write + acts
    tokens = b * s
    opt_traffic = 20.0 * n_total
    acts = tokens * L * d * 24.0
    return opt_traffic + acts


@dataclass(frozen=True)
class ServingTickCost:
    """Roofline-derived cost (seconds) of one :class:`ServingEngine` tick.

    Built once per engine from its ``ArchConfig`` via :func:`tick_cost_model`;
    the engine feeds it per-tick work counters:

        memory_s  = (weight stream + KV pages touched + activations) / HBM_BW
        compute_s = 2·N_active·tokens / PEAK_FLOPS
        stall_s   = stalled page traffic / PCIE_BW   (serial: DMA blocks decode)

        tick_seconds = max(memory_s, compute_s) + stall_s

    A tick that ran no forward pass (admission/bookkeeping only) costs one
    ``idle_s`` — small but nonzero so straggler statistics, which multiply
    observed tick cost by host slowdown, keep a live signal.
    """

    weight_bytes: float  # bf16 weight stream, read once per forward tick
    active_params: float  # FLOP term: 2·active_params per token
    kv_write_bytes_per_token: float  # KV appended per prefilled token
    act_bytes_per_token: float  # activation traffic envelope per token
    page_bytes: float  # one KV page (the stall DMA unit)
    idle_s: float = 1e-6
    hbm_bw: float = HBM_BW
    peak_flops: float = PEAK_FLOPS
    pcie_bw: float = PCIE_BW

    def tick_seconds(
        self,
        *,
        decode_tokens: int = 0,
        prefill_tokens: int = 0,
        kv_bytes_read: float = 0.0,
        stall_events: int = 0,
    ) -> float:
        """Seconds for one tick that decoded ``decode_tokens`` requests
        (reading ``kv_bytes_read`` of resident KV), consumed
        ``prefill_tokens`` of prompt, and hit ``stall_events`` page-pool
        stalls (each charged one page DMA over the host link)."""
        tokens = decode_tokens + prefill_tokens
        stall_s = stall_events * (self.page_bytes / self.pcie_bw)
        if tokens <= 0:
            return self.idle_s + stall_s
        mem = (
            self.weight_bytes
            + kv_bytes_read
            + prefill_tokens * self.kv_write_bytes_per_token
            + tokens * self.act_bytes_per_token
        ) / self.hbm_bw
        comp = 2.0 * self.active_params * tokens / self.peak_flops
        return max(mem, comp) + stall_s


def tick_cost_model(cfg, page_tokens: int = 16) -> ServingTickCost:
    """Build a :class:`ServingTickCost` from an ``ArchConfig``: bf16
    weights streamed once per tick, ``cfg.kv_bytes_per_token()`` per
    written token, and a 24 B/element/layer activation envelope."""
    kv_tok = cfg.kv_bytes_per_token()
    return ServingTickCost(
        weight_bytes=2.0 * cfg.param_count(),
        active_params=float(cfg.active_param_count()),
        kv_write_bytes_per_token=float(kv_tok),
        act_bytes_per_token=cfg.n_layers * cfg.d_model * 24.0,
        page_bytes=float(kv_tok * page_tokens),
    )


@dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    compute_s: float  # analytic useful compute (remat-adjusted) / peak
    memory_s: float  # analytic traffic / HBM bw
    collective_s: Optional[float]  # bytes by axis / link rate; None: unknown
    model_flops: float
    traced_flops_global: float
    traced_compute_s: float  # counted FLOPs per device / peak
    temp_bytes: Optional[int]
    collectives: Optional[Dict[str, dict]]

    def _terms(self) -> Dict[str, float]:
        terms = {"compute": self.compute_s, "memory": self.memory_s}
        if self.collective_s is not None:
            terms["collective"] = self.collective_s
        return terms

    @property
    def bottleneck(self) -> str:
        terms = self._terms()
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time bound: no-overlap = max of the terms that
        exist (each unit is independently saturable)."""
        return max(self._terms().values())

    @property
    def useful_fraction(self) -> float:
        if self.traced_flops_global <= 0:
            return 0.0
        return self.model_flops / self.traced_flops_global

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the step-time bound:
        (useful FLOPs / chips / step_time) / peak — the §Perf score."""
        chips = CHIPS[self.mesh]
        if self.step_time_s <= 0:
            return 0.0
        return (self.model_flops / chips / self.step_time_s) / PEAK_FLOPS


def link_bw(mesh_axes, axis: str) -> float:
    """The rate of the link a collective over ``axis`` ("+"-joined where
    it spans several mesh axes) crosses on a mesh of ``mesh_axes``
    ([name, size] pairs, outermost first): NVLink where the group's
    ranks fall in one node of NODE_CARDS, else InfiniBand."""
    names = [n for n, _ in mesh_axes]
    span = 0
    for part in axis.split("+"):
        if part not in names:
            return NVLINK_BW
        i = names.index(part)
        stride = 1
        for _, size in mesh_axes[i + 1:]:
            stride *= size
        span += (mesh_axes[i][1] - 1) * stride
    return NVLINK_BW if span < NODE_CARDS else IB_BW


def collective_seconds(coll: Dict[str, dict], mesh_axes=None) -> float:
    """Seconds of a record's collectives: each kind's bytes by mesh axis
    at the rate of the link that axis crosses (:func:`link_bw`); bytes
    a record does not place on an axis at NVLink's rate."""
    total = 0.0
    for entry in coll.values():
        axes = entry.get("axes") if mesh_axes else None
        if not axes:
            total += entry.get("bytes", 0) / NVLINK_BW
            continue
        for axis, a in axes.items():
            total += a.get("bytes", 0) / link_bw(mesh_axes, axis)
    return total


def load_cell(record: dict) -> Optional[RooflineCell]:
    if record.get("skipped") or "error" in record:
        return None
    flops_dev = record.get("cost", {}).get("flops", 0.0)
    coll = record.get("collectives")
    chips = CHIPS[record["mesh"]]
    arch, shape = record["arch"], record["shape"]
    mflops = model_flops(arch, shape)
    remat = 4.0 / 3.0 if record.get("kind") == "train" else 1.0
    traffic = memory_traffic_bytes(arch, shape)
    return RooflineCell(
        arch=arch,
        shape=shape,
        mesh=record["mesh"],
        compute_s=mflops * remat / chips / PEAK_FLOPS,
        memory_s=traffic / chips / HBM_BW,
        collective_s=(None if coll is None else
                      collective_seconds(coll, record.get("mesh_axes"))),
        model_flops=mflops,
        traced_flops_global=flops_dev * chips,
        traced_compute_s=flops_dev / PEAK_FLOPS,
        temp_bytes=record.get("memory", {}).get("temp_size_in_bytes"),
        collectives=coll,
    )


def load_all(dryrun_dir: str, mesh: str = "16x16") -> List[RooflineCell]:
    cells = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("mesh") != mesh:
            continue
        cell = load_cell(rec)
        if cell is not None:
            cells.append(cell)
    return cells


def _sci(x: Optional[float], fmt: str = ".3e") -> str:
    return "–" if x is None else format(x, fmt)


def markdown_table(cells: List[RooflineCell]) -> str:
    hdr = (
        "| arch | shape | compute s | memory s | collective s | bottleneck "
        "| roofline frac | traced compute s | temp GiB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for c in cells:
        temp = f"{c.temp_bytes / 2**30:.1f}" if c.temp_bytes else "–"
        rows.append(
            f"| {c.arch} | {c.shape} | {c.compute_s:.3e} | {c.memory_s:.3e} "
            f"| {_sci(c.collective_s)} | **{c.bottleneck}** "
            f"| {c.roofline_fraction:.3f} "
            f"| {c.traced_compute_s:.2e} | {temp} |"
        )
    return hdr + "\n".join(rows) + "\n"


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    cells = load_all(args.dir, args.mesh)
    print(markdown_table(cells))
    worst = sorted(cells, key=lambda c: c.roofline_fraction)[:3]
    coll = sorted((c for c in cells if c.collective_s is not None),
                  key=lambda c: -c.collective_s)[:3]
    print("\nworst roofline fraction:", [(c.arch, c.shape) for c in worst])
    print("most collective-bound:", [(c.arch, c.shape) for c in coll])


if __name__ == "__main__":
    main()
