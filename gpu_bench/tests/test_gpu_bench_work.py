"""The benchmark's frozen copies of the counts of work agree with the
numbers the port's chip smoke test pins (tests/test_torch_bwd_bounds.py)
and with the masks they count."""

import pytest

from gpu_bench import work


def test_grouped_matmul_backward_pair_at_granites_training_shapes():
    """128.8 GFLOP for K5's backward pair at E 40, C 1,024, D 1,536,
    F 512, bound by operations at 0.130 ms."""
    (pair_bytes, pair_flops), (one_bytes, one_flops) = work.gmm_bwd_work(
        40, 1024, 1536, 512)
    assert round(pair_flops / 1e9, 1) == 128.8
    assert one_bytes == 230_686_720 and pair_bytes == 419_430_400
    s, by = work.bound(pair_bytes, pair_flops)
    assert by == "operations" and round(1e3 * s, 3) == 0.130


def test_ssd_backward_at_mamba2s_microbatch():
    n_bytes, flops = work.ssd_bwd_work(2, 2048, 80, 64, 128, 256)
    assert round(flops / 1e9, 1) == 34.7
    s, by = work.bound(n_bytes, flops, bf16=False)
    assert by == "operations" and round(1e3 * s, 3) == 0.517


@pytest.mark.parametrize("b,ms", [(4, 0.174), (2, 0.087)])
def test_flash_backward_five_products(b, ms):
    n_bytes, flops, pairs, empty = work.flash_bwd_work(
        b, 16, 8, 2048, 128, 128, True, 0)
    assert pairs == 2048 * 2049 // 2 and empty == 0
    s, by = work.bound(n_bytes, flops)
    assert by == "operations" and round(1e3 * s, 3) == ms


@pytest.mark.parametrize("sq,sk,off", [(5, 5, 0), (3, 10, 4), (4, 6, 4),
                                       (1, 1, 0), (7, 7, 3), (64, 512, 448)])
def test_causal_pairs_closed_form(sq, sk, off):
    assert work.causal_pairs(sq, sk, off) == work.kept_pairs(
        sq, sk, True, 0, off)[0]


def test_paged_decode_reads_each_groups_keys_once():
    lens = [10, 10, 7, 7, 0, 0]  # 3 rows of 2 heads sharing a kv head
    n_bytes, flops = work.paged_decode_work(lens, 2, 128)
    assert n_bytes == 2 * (2 * 17 * 128 + 2 * 6 * 128) + 4 * 6
    assert flops == 4 * 128 * 34


def test_train_step_flops_of_internlm2():
    m = {"hidden_size": 2048, "num_hidden_layers": 24,
         "num_attention_heads": 16, "num_key_value_heads": 8,
         "head_dim": 128, "intermediate_size": 8192, "vocab_size": 92544}
    per_tok = 24 * (2 * 2048 * 2048 + 2 * 2048 * 1024 + 3 * 2048 * 8192) \
        + 2048 * 92544
    attn = 12 * 24 * 16 * 128 * (4 * 2048 * 2049 // 2)
    assert work.train_step_flops(m, 4, 2048) == 6 * per_tok * 4 * 2048 + attn
