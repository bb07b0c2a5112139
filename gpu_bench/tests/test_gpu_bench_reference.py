"""The plain references against the port at test size on the CPU, in
float32 on both sides: the port is imported here, on the test side only;
the reference modules import nothing of it."""

import subprocess
import sys

import pytest
import torch

from conftest import REPO, SMALL

from gpu_bench import port, weights
from gpu_bench.reference import granite_moe, internlm2

DENSE = dict(SMALL, intermediate_size=128, rms_norm_eps=1e-5,
             rope_theta=10000.0, tie_word_embeddings=False)
MOE = dict(SMALL, intermediate_size=32, num_local_experts=8,
           num_experts_per_tok=2, capacity_factor=1.25, rms_norm_eps=1e-6,
           rope_theta=10000.0, tie_word_embeddings=True)
CASES = {"internlm2": ("internlm2-1.8b", DENSE, internlm2),
         "granite_moe": ("granite-moe-3b-a800m", MOE, granite_moe),
         # a capacity that drops entries in every sequence
         "granite_moe_drops": ("granite-moe-3b-a800m",
                               dict(MOE, capacity_factor=0.5), granite_moe)}


def f32_weights(model, seed=3):
    return {k: v.float() for k, v in weights.leaves(model, seed, "cpu")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_logits_agree(name):
    from repro_torch.models.transformer import forward

    arch_name, model, ref = CASES[name]
    cfg = port.arch({"port_arch": arch_name, "model": model})
    w = f32_weights(model)
    tokens = torch.randint(0, model["vocab_size"], (2, 40),
                           generator=torch.Generator().manual_seed(1))
    got = forward(cfg, weights.program_tree(model, w), tokens, remat=False)
    want = internlm2.logits(model, w, tokens, ffn=ref.FFN)
    assert torch.allclose(got, want, atol=2e-4, rtol=1e-4), \
        (got - want).abs().max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_agree(name, monkeypatch):
    """With the port's bf16 rounding of the residual stream's gradient at
    block boundaries made the identity (the rule of a bf16 model, which
    an f32 comparison leaves out), the port's f32 gradients are the
    reference's."""
    from repro_torch.models import transformer
    from repro_torch.train.train_step import value_and_grad

    monkeypatch.setattr(transformer, "bf16_grad", lambda x: x)

    arch_name, model, ref = CASES[name]
    cfg = port.arch({"port_arch": arch_name, "model": model})
    w = f32_weights(model)
    tokens = torch.randint(0, model["vocab_size"], (2, 32),
                           generator=torch.Generator().manual_seed(2))
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    tree = weights.program_tree(model, {k: v.clone() for k, v in w.items()})
    loss, grads = value_and_grad(cfg, tree, {"tokens": tokens,
                                             "labels": labels})
    got = weights.program_leaves(model, grads)
    p = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    want_loss = internlm2.loss(model, p, tokens, labels, ffn=ref.FFN)
    want = dict(zip(p, torch.autograd.grad(want_loss, list(p.values()))))
    assert abs(float(loss) - float(want_loss.detach())) < 1e-5
    for k in want:
        assert torch.allclose(got[k].float(), want[k], atol=1e-5,
                              rtol=1e-3), k


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); "
            "import gpu_bench.reference.internlm2, "
            "gpu_bench.reference.granite_moe, gpu_bench.reference.adamw; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))"
            % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


def test_the_small_capacity_drops():
    model = CASES["granite_moe_drops"][1]
    assert granite_moe.capacity(model, 40) == 8 < 40 * 2 / 8
