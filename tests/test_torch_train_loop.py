"""The port's training loop against the JAX package's on the CPU:
``Trainer`` runs of internlm2 smoke from the same parameters (the JAX
package's ``init_model``, carried across) over the same data pipeline
batches — plain, MURS-adaptive microbatching and int8 error-feedback
gradient compression — with their losses compared step by step; both
packages resuming from the port's checkpoint; the launcher; and one
train step of every other architecture.

Tolerance: bf16 parameters, activations and gradients on both sides,
rounded from f32 sums taken in different orders; the losses of a few
steps at lr 1e-3 agree within ``LOSS_ATOL`` = 0.02 (measured at most
9e-4 on this CPU, plain and compressed).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.optim.adamw import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models import init_model  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402

LOSS_ATOL = 0.02
ARCH = "internlm2-1.8b"
SHAPE = ShapeConfig("t", 16, 4, "train")


class _FromJaxParams(Trainer):
    """The port's Trainer started from the JAX package's ``init_model``
    at the same seed (the two packages' generators differ)."""

    def init_params(self):
        params = jm.init_model(self.cfg_jax, jax.random.PRNGKey(
            self.tcfg.seed))
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                 self.device)


def _trainers(tmp_path, steps, **kw):
    """(JAX trainer, port trainer) of internlm2 smoke, same config."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=8)
    common = dict(steps=steps, ckpt_every=2, log_every=1, **kw)
    jt = JTrainer(ARCHS[ARCH].smoke(), SHAPE, JTrainerConfig(
        ckpt_dir=str(tmp_path / "jax"), opt=JAdamWConfig(**opt), **common))
    tt = _FromJaxParams(TARCHS[ARCH].smoke(), SHAPE, TrainerConfig(
        ckpt_dir=str(tmp_path / "port"), opt=tadamw.AdamWConfig(**opt),
        device="cpu", **common))
    tt.cfg_jax = ARCHS[ARCH].smoke()
    return jt, tt


def _losses(out):
    return [m["loss"] for m in out["log"]]


def test_trainer_losses_match_jax_and_resume(tmp_path):
    """3 steps, a checkpoint at step 2; then a port trainer and a JAX
    trainer each resume from the PORT's step-2 file and run step 3.  Both
    packages restart the data stream at batch 0 on resume (the JAX
    package's ``DataPipeline`` ignores the restored step: ROADMAP Queue
    3), so step 3 sees batch 0 again in both, and their losses agree."""
    jt, tt = _trainers(tmp_path, 3)
    j_out, t_out = jt.run(), tt.run()
    assert t_out["final_step"] == j_out["final_step"] == 3
    np.testing.assert_allclose(_losses(t_out), _losses(j_out),
                               atol=LOSS_ATOL, rtol=0)
    port_dir = tmp_path / "port"
    assert sorted(p.name for p in port_dir.iterdir()) == ["ckpt_2.ckpt"]
    again = _FromJaxParams(TARCHS[ARCH].smoke(), SHAPE, tt.tcfg)
    again.cfg_jax = tt.cfg_jax
    out = again.run()  # step 3 writes no checkpoint (every 2)
    j_again = JTrainer(ARCHS[ARCH].smoke(), SHAPE, JTrainerConfig(
        steps=3, ckpt_every=2, log_every=1, ckpt_dir=str(port_dir),
        opt=jt.tcfg.opt))
    j_resumed = j_again.run()
    assert [m["step"] for m in out["log"]] == [3]
    assert [m["step"] for m in j_resumed["log"]] == [3]
    np.testing.assert_allclose(_losses(out), _losses(j_resumed),
                               atol=LOSS_ATOL, rtol=0)


def test_adaptive_microbatching_matches_jax(tmp_path):
    """The pressure probe of ``tests/test_substrate.py``'s adaptive run
    (shortened to 5 steps): the same factor history (1, then doubled by
    red readings up to the batch of 4) and the same losses."""
    readings = [0.1, 0.1, 0.9, 0.9, 0.9]
    jt, tt = _trainers(tmp_path, 5)
    for t in (jt, tt):
        it = iter(readings)
        t.tcfg.hbm_probe = lambda it=it: next(it, 0.9)
        t.__init__(t.cfg, t.shape, t.tcfg)
    tt.cfg_jax = ARCHS[ARCH].smoke()
    j_out, t_out = jt.run(), tt.run()
    assert tt._adaptive.history == jt._adaptive.history
    assert max(h["factor"] for h in tt._adaptive.history) == 4
    np.testing.assert_allclose(_losses(t_out), _losses(j_out),
                               atol=LOSS_ATOL, rtol=0)


def test_compressed_gradient_run_matches_jax(tmp_path):
    """int8 error-feedback gradients: the same losses, and the same wire
    size of one exchange."""
    jt, tt = _trainers(tmp_path, 2, grad_compression=True)
    j_out, t_out = jt.run(), tt.run()
    assert tt.compressed_wire_bytes == jt.compressed_wire_bytes
    np.testing.assert_allclose(_losses(t_out), _losses(j_out),
                               atol=LOSS_ATOL, rtol=0)


def test_launcher_trains_on_the_cpu(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import train as launch

    monkeypatch.setattr("sys.argv", [
        "train", "--arch", ARCH, "--device", "cpu", "--steps", "2",
        "--ckpt-dir", str(tmp_path)])
    launch.main()
    out = capsys.readouterr().out
    assert "finished at step 2" in out


@pytest.mark.parametrize("arch", [
    "deepseek-v2-236b", "stablelm-1.6b", "qwen1.5-110b", "whisper-base",
    "internvl2-26b", "mamba2-2.7b", "zamba2-1.2b"])
def test_one_train_step_of_every_other_architecture(arch):
    """Port only: a train step (two microbatches) of the smoke model,
    front-end inputs from the data pipeline's batch, a finite loss and
    grad norm; every parameter leaf with a non-zero gradient moved, and
    every leaf with a zero gradient (one the loss does not reach) left as
    it was.  No weight decay, and a full learning rate at the first step
    (1e-2: Adam's first step moves every element with a gradient by the
    rate, more than half a bf16 ulp of the parameters' magnitudes)."""
    from repro_torch.data.pipeline import DataConfig, _host_batch

    cfg = TARCHS[arch].smoke()
    params = init_model(cfg, 0, device="cpu")
    before = [t.clone() for t in _leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in _host_batch(
        cfg, ShapeConfig("t", 16, 2, "train"), DataConfig(seed=2), 0
    ).items()}
    _, grads = tstep.value_and_grad(cfg, params, batch)
    reached = [bool(g.detach().ne(0).any()) for g in _leaves(grads)]
    step = tstep.make_train_step(
        cfg, tadamw.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.0),
        microbatches=2)
    params, state, metrics = step(params, tadamw.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    assert any(reached)
    for i, (a, b, r) in enumerate(zip(_leaves(params), before, reached)):
        assert torch.equal(a, b) != r, (i, r)


def _leaves(tree):
    from repro_torch.tree import tree_leaves

    return [t.detach() for t in tree_leaves(tree)]
