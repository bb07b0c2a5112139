"""What decides ``correct``: the program passes at test size, and the
control (the reference in float8) and each fault a cell can have, planted
underneath a run that is otherwise whole, come out as not correct.

The limits at this size (conftest.TINY_LIMITS) sit between the readings
these runs give: serve, the program's widest gap 0.005-0.03 and the
control's 0.5-0.6; train, the dense model's gradient norm gap 0.0012
against the control's 0.015; the MoE model's, over eight seeds, gradient
norm gap 0.0010-0.0022 against the control's 0.016-0.030 and the half
batch's 0.041-0.097, median leaf's direction gap 0.012-0.019 against
0.197-0.312 and 0.63-0.92, and widest gap of its choices of experts
0.013-0.037 against the control's 0.29-0.56 and 4.4-5.4 for experts
other than the router's; the change gap 0.06-0.16 (bf16 weights take
updates a fraction of their ulp at this width) against 1 for a state
left unchanged."""

import subprocess
import sys

import pytest

from conftest import REPO, TINY_LIMITS, run_cell


def test_serve_passes_and_its_control_fails(tiny_root):
    out = run_cell(tiny_root, "tiny-murs", control=True)
    assert out["correct"]
    gap = out["compared"]["max_logit_gap"]
    assert gap["value"] < gap["limit"]
    assert out["control"]["control_max_logit_gap"] > gap["limit"]


@pytest.mark.parametrize("cell,config", [("tiny-moe-train", "moe"),
                                         ("tiny-dense-train", "dense")])
def test_train_passes_and_its_control_and_half_batch_fail(tiny_root, cell,
                                                         config):
    out = run_cell(tiny_root, cell, control=True)
    assert out["correct"], out["compared"]
    lim = TINY_LIMITS[config]["train"]
    for reading in ("control", "fault_half_batch"):
        got = out["control"][reading]
        assert any(k in got and got[k] > lim[k] for k in lim), (reading, got)


def test_a_token_altered_where_produced_is_not_correct(tiny_root,
                                                       monkeypatch):
    from repro_torch.serve.engine import ServingEngine

    real = ServingEngine._decode_paged_batch

    def altered(self, active, plan):
        return (real(self, active, plan) + 1) % self.cfg.vocab

    monkeypatch.setattr(ServingEngine, "_decode_paged_batch", altered)
    out = run_cell(tiny_root, "tiny-murs")
    assert not out["correct"]
    assert out["compared"]["max_logit_gap"]["value"] > \
        TINY_LIMITS["dense"]["serve"]["max_logit_gap"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(
        tiny_root, monkeypatch):
    from repro_torch.optim import adamw

    monkeypatch.setattr(adamw, "update",
                        lambda cfg, grads, state, params: (
                            params, state, adamw.global_norm(grads)))
    out = run_cell(tiny_root, "tiny-moe-train")
    assert not out["correct"]
    assert out["compared"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(tiny_root, monkeypatch):
    from repro_torch.train import train_step

    real = train_step.pin_batch
    monkeypatch.setattr(train_step, "pin_batch", lambda b: real(
        {k: v[: v.shape[0] // 2] for k, v in b.items()}))
    out = run_cell(tiny_root, "tiny-moe-train")
    assert not out["correct"]


def test_experts_other_than_the_routers_choice_are_not_correct(
        tiny_root, monkeypatch):
    from repro_torch.models import blocks

    real = blocks.moe_dispatch_row
    monkeypatch.setattr(blocks, "moe_dispatch_row",
                        lambda x, gates, top_k, cap: real(
                            x, gates.roll(1, dims=-1), top_k, cap))
    out = run_cell(tiny_root, "tiny-moe-train")
    assert not out["correct"]
    assert out["compared"]["route_gap"]["value"] > \
        TINY_LIMITS["moe"]["train"]["route_gap"]


def test_recorded_routes_are_each_tokens_top_k_dropped_ones_too():
    import torch

    from gpu_bench import port
    from repro_torch.models import blocks

    gen = torch.Generator().manual_seed(3)
    gates = torch.softmax(torch.randn(2, 64, 8, generator=gen), dim=-1)
    gates[:, :, 5] += 1.0  # every token wants expert 5: most are dropped
    calls = []
    with port.record_routes(calls):
        blocks.moe_dispatch_row(torch.randn(2, 64, 4, generator=gen), gates,
                                2, 8)
    (got,) = calls
    want = torch.topk(gates, 2, dim=-1).indices.sort(dim=-1).values
    assert torch.equal(got.long(), want)


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "from gpu_bench import run; "
            "out, _ = run.execute(__import__('pathlib').Path(%r), "
            "'tiny-chat', 7, 2, False, 'cpu'); "
            "print(out['correct'], run.forbidden_modules())"
            % (str(REPO), str(REPO / "src"), str(tiny_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_the_command_refuses_without_a_card_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "gpu_bench/run.py", "--workload",
         "serve-internlm2-murs", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-murs", "tiny-moe-train"])
def test_test_size_cells_on_the_card(tiny_root, card, cell):
    from gpu_bench import run

    out = run.execute(tiny_root, cell, 11, 3, True, card)[0]
    assert out["correct"] and out["device"]["busy_s"] > 0
