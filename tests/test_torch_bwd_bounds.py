"""The bounds of the three backward kernels' rows in PERF.md, pinned on
the CPU: ``chip_smoke.py``'s operation counts and bounds at the training
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


@pytest.mark.parametrize("d,f,pair", [(1536, 512, 419_430_400),
                                      (512, 1536, 335_544_320)])
def test_grouped_matmul_backward_bounds_at_granites_training_shapes(d, f,
                                                                    pair):
    """K5's backward at granite-moe's training shapes (E 40, C 1,024: two
    sequences at capacity 512; gate/up and down): a product moves
    230,686,720 bytes for 64.4 GFLOP, 0.069 ms of bytes; the pair reads
    x, w and dy and writes dx and dw once (419.4 MB for gate/up, 335.5 MB
    for down) for 128.8 GFLOP, 0.130 ms of operations."""
    (pair_bytes, pair_flops), (one_bytes, one_flops) = (
        chip_smoke.gmm_bwd_work(40, 1024, d, f))
    assert one_bytes == 230_686_720 and round(one_flops / 1e9, 1) == 64.4
    ms, by = chip_smoke.bound(one_bytes, one_flops, torch.bfloat16, torch)
    assert by == "bytes" and round(ms, 3) == 0.069
    assert pair_bytes == pair and pair_flops == 2 * one_flops
    ms, by = chip_smoke.bound(pair_bytes, pair_flops, torch.bfloat16, torch)
    assert by == "operations" and round(ms, 3) == 0.130
