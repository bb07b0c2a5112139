"""Roofline cost of one serving-engine tick on an NVIDIA H100.

The constants are the H100 SXM part's (NVIDIA's data sheet, dense rates
without sparsity, 700 W): ``nvidia-smi`` names it "NVIDIA H100 80GB
HBM3".  The PCIe part is slower on every term (756 TFLOP/s bf16,
2.0 TB/s) and is not what these numbers describe.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAK_FLOPS = 989e12  # bf16 dense tensor-core FLOP/s
FP32_PEAK_FLOPS = 67e12  # f32 FLOP/s on the CUDA cores, outside the tensor cores
HBM_BW = 3.35e12  # HBM3 bytes/s
PCIE_BW = 64e9  # bytes/s host link, PCIe Gen5 x16 — KV offload/promote path


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
