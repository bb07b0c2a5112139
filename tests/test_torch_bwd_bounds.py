"""The bounds of the two backward kernels' rows in PERF.md, pinned on the
CPU: ``chip_smoke.py``'s operation counts and bounds at the training
shapes (the H100's published peaks: f32 67 TFLOP/s on the CUDA cores,
dense TF32 495 and bf16 989 TFLOP/s on the tensor cores, HBM 3.35
TB/s)."""

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402


def test_ssd_backward_bounds_at_mamba2s_microbatch():
    """34.7 GFLOP at mamba2's B 2 x S 2,048 (80 heads of 64, ds 128, Q
    256): 0.517 ms on the f32 CUDA cores, 0.210 ms as 3xTF32."""
    n_bytes, flops = chip_smoke.ssd_bwd_work(2, 2048, 80, 64, 128, 256)
    assert round(flops / 1e9, 1) == 34.7
    ms, by = chip_smoke.bound(n_bytes, flops, torch.float32, torch)
    assert by == "operations" and round(ms, 3) == 0.517
    assert chip_smoke.TF32_PASSES == 3
    assert round(chip_smoke.tf32_bound_ms(flops), 3) == 0.210


def test_ssd_backward_bound_at_zamba2s_microbatch():
    n_bytes, flops = chip_smoke.ssd_bwd_work(2, 2048, 64, 64, 64, 256)
    ms, by = chip_smoke.bound(n_bytes, flops, torch.float32, torch)
    assert by == "operations" and round(ms, 3) == 0.272


@pytest.mark.parametrize("b,bound_ms", [(4, 0.174), (2, 0.087)])
def test_flash_backward_counts_five_products(b, bound_ms):
    """K3's backward at internlm2 (16 q heads over 8, S 2,048, hd 128,
    causal): five products of 2 hd operations a kept pair, at bf16's
    peak."""
    s, hd = 2048, 128
    n_bytes, flops, pairs, empty = chip_smoke.flash_bwd_work(
        b, 16, 8, s, hd, hd, True, 0)
    assert pairs == s * (s + 1) // 2 and empty == 0
    assert flops == 5 * 2 * hd * b * 16 * pairs
    ms, by = chip_smoke.bound(n_bytes, flops, torch.bfloat16, torch)
    assert by == "operations" and round(ms, 3) == bound_ms
