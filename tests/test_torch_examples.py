"""The port's examples (``examples/torch_*.py``) on the CPU, each in a
subprocess with ``--device cpu`` and the smallest flags its JAX twin
takes, with ``jax`` and the JAX package blocked: each prints its twin's
outcome.  Without ``--device`` the three that touch a device ask for the
card, and where there is none they fail instead of running on the CPU.
"""

import math
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
#: each example's run; the JAX package and jax raise on import
_RUN = ("import runpy, sys; sys.modules['jax'] = None; "
        "sys.modules['repro'] = None; sys.argv = sys.argv[1:]; "
        "runpy.run_path(sys.argv[0], run_name='__main__')")


def _run(name, *args, check=True):
    # two threads each: the suite runs beside other test processes
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _RUN, os.path.join(EXAMPLES, name), *args],
        capture_output=True, text=True, env=env, timeout=300)
    if check:
        assert out.returncode == 0, out.stdout + out.stderr
    return out


def _losses(text):
    return [float(x) for x in re.findall(r"loss (\S+)", text)]


def test_quickstart_trains_checkpoints_and_resumes():
    out = _run("torch_quickstart.py", "--device", "cpu").stdout
    assert "trained to step 20" in out
    assert "resumed from ckpt → 25" in out
    losses = _losses(out)
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)


def test_train_lm_runs_its_smallest_flags(tmp_path):
    out = _run("torch_train_lm.py", "--device", "cpu", "--steps", "1",
               "--batch", "2", "--seq", "32", "--ckpt-dir",
               str(tmp_path)).stdout
    assert "model: lm-100m  params=124.7M" in out
    final = re.search(r"done: step 1  final loss (\S+)", out)
    assert final and math.isfinite(float(final.group(1))), out


def test_serve_multitenant_completes_every_request_under_both_policies():
    out = _run("torch_serve_multitenant.py", "--device", "cpu").stdout
    rows = dict(re.findall(r"^(FAIR \(stock\)|MURS)\s+(completed .*)$", out,
                           re.M))
    assert sorted(rows) == ["FAIR (stock)", "MURS"], out
    for row in rows.values():
        assert row.startswith("completed 7/7  failed 0"), out
    # the pool holds about 80 tokens against the workload's demand: MURS
    # suspends where FAIR over-commits
    assert int(re.search(r"suspensions (\d+)", rows["MURS"]).group(1)) > 0


def test_murs_spark_repro_prints_its_twins_table():
    """The port's simulator is the JAX package's copy: the same table, to
    the character, as ``examples/murs_spark_repro.py`` prints."""
    out = _run("torch_murs_spark_repro.py").stdout
    twin = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "murs_spark_repro.py")],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                 JAX_PLATFORMS="cpu"))
    assert twin.returncode == 0, twin.stderr
    assert out == twin.stdout
    assert "MURS:" in out and "grep: exec=" in out


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_train_lm.py",
                                  "torch_serve_multitenant.py"])
def test_device_examples_ask_for_the_card_by_default(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    out = _run(name, check=False)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
