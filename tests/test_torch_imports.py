"""The port stands alone: no JAX and no module of the JAX package.

In a fresh interpreter with ``jax`` blocked, every ``repro_torch`` module
is imported and a two-request engine runs on the CPU — some imports
happen lazily at call time, so the run is part of the check — and then no
``repro`` module may be loaded.
"""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _port_modules():
    import repro_torch

    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_is_listed():
    names = _port_modules()
    for expected in (
        "repro_torch.kernels.paged_decode",
        "repro_torch.models.transformer",
        "repro_torch.serve.engine",
        "repro_torch.launch.serve",
    ):
        assert expected in names


def test_port_imports_and_serves_without_jax_or_repro():
    script = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.path.insert(0, {SRC!r})
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        from repro_torch.configs import ARCHS
        from repro_torch.models import init_model
        from repro_torch.sched import MursConfig, MursPolicy
        from repro_torch.serve import EngineConfig, Request, ServingEngine
        cfg = ARCHS["internlm2-1.8b"].smoke()
        eng = ServingEngine(
            cfg, init_model(cfg, 0, device="cpu"),
            EngineConfig(
                n_slots=2, max_seq=32, hbm_capacity_bytes=1e9,
                policy=MursPolicy(MursConfig.for_serving(period=1.0)),
                device="cpu",
            ),
        )
        eng.submit(Request("r0", "A", list(range(5, 12)), 4))
        eng.submit(Request("r1", "B", list(range(20, 23)), 3))
        rep = eng.run(max_ticks=50)
        assert rep.completed == 2 and eng.paged_decode_ticks > 0
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro.")
                     or m == "jax" and sys.modules[m] is not None)
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
        """
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
