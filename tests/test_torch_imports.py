"""The port stands alone: no JAX, no module of the JAX package, and no
``msgpack`` (the machine with the card has none; the port packs with its
own codec).

In a fresh interpreter with ``jax`` and ``msgpack`` blocked, every
``repro_torch`` module is imported, three small engines (internlm2,
zamba2 and deepseek-v2's MLA) run on the CPU, whisper and internvl2 run
a prefill with their front-end inputs and a decode step, the paper's
simulator runs a job, and a front door over a two-replica cluster
serves a short trace while writing a KV checkpoint, crashing a replica
and restoring it — some imports happen lazily at call time, so the run
is part of the check — and then no ``repro`` module may be loaded.
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
        "repro_torch.kernels.flash_attention",
        "repro_torch.kernels.decode_attention",
        "repro_torch.kernels.grouped_matmul",
        "repro_torch.kernels.ssd_scan",
        "repro_torch.kernels.splits",
        "repro_torch.configs.gemma3_1b",
        "repro_torch.configs.granite_moe_3b_a800m",
        "repro_torch.configs.mamba2_2_7b",
        "repro_torch.configs.zamba2_1_2b",
        "repro_torch.configs.deepseek_v2_236b",
        "repro_torch.configs.stablelm_1_6b",
        "repro_torch.configs.qwen1_5_110b",
        "repro_torch.configs.whisper_base",
        "repro_torch.configs.internvl2_26b",
        "repro_torch.core.tasks",
        "repro_torch.core.service",
        "repro_torch.core.spark_sim",
        "repro_torch.models.transformer",
        "repro_torch.serve.engine",
        "repro_torch.launch.serve",
        "repro_torch.sched.priority",
        "repro_torch.serve.traffic",
        "repro_torch.serve.frontdoor",
        "repro_torch.serve.cluster",
        "repro_torch.checkpoint",
        "repro_torch.checkpoint.checkpointing",
        "repro_torch.checkpoint._msgpack",
        "repro_torch.dist.fault",
        "repro_torch.tree",
        "repro_torch.optim",
        "repro_torch.optim.adamw",
        "repro_torch.train",
        "repro_torch.train.train_step",
        "repro_torch.train.pressure",
        "repro_torch.train.trainer",
        "repro_torch.data",
        "repro_torch.data.pipeline",
        "repro_torch.launch.train",
        "repro_torch.dist.compression",
        "repro_torch.dist.sharding",
        "repro_torch.dist.presets",
        "repro_torch.launch.mesh",
        "repro_torch.launch.specs",
        "repro_torch.launch.dryrun",
        "repro_torch.roofline",
        "repro_torch.roofline.analysis",
    ):
        assert expected in names


def test_port_imports_and_serves_without_jax_or_repro():
    script = textwrap.dedent(
        f"""
        import importlib, sys
        sys.modules["jax"] = None  # any import of jax now raises
        sys.modules["msgpack"] = None  # and of msgpack
        sys.path.insert(0, {SRC!r})
        for name in {_port_modules()!r}:
            importlib.import_module(name)
        from repro_torch.kernels import ops
        assert {{"grouped_matmul", "grouped_matmul_bwd", "flash_attention_bwd",
                 "ssd_scan_bwd"}} <= {{f.__name__ for f in ops.WRAPPERS}}
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
        # the hybrid SSM stack: Mamba-2 blocks and zamba2's shared attention
        cfg = ARCHS["zamba2-1.2b"].smoke()
        eng = ServingEngine(
            cfg, init_model(cfg, 0, device="cpu"),
            EngineConfig(n_slots=2, max_seq=40, hbm_capacity_bytes=1e9,
                         device="cpu"),
        )
        eng.submit(Request("z0", "A", list(range(5, 40)), 3))
        assert eng.run(max_ticks=50).completed == 1
        # MLA with routed and shared experts on the engine's dense path;
        # whisper and internvl2 through prefill(extra=...) and decode
        import torch
        from repro_torch.models import decode_step, prefill
        cfg = ARCHS["deepseek-v2-236b"].smoke()
        eng = ServingEngine(
            cfg, init_model(cfg, 0, device="cpu"),
            EngineConfig(n_slots=2, max_seq=32, hbm_capacity_bytes=1e9,
                         device="cpu"),
        )
        eng.submit(Request("d0", "A", list(range(5, 12)), 3))
        assert eng.run(max_ticks=50).completed == 1
        for name, key, n in (("whisper-base", "frame_embeds", 10),
                             ("internvl2-26b", "patch_embeds", 8)):
            cfg = ARCHS[name].smoke()
            p = init_model(cfg, 0, device="cpu")
            extra = {{key: torch.zeros(1, n, cfg.d_model,
                                      dtype=torch.bfloat16)}}
            _, c = prefill(cfg, p, torch.ones(1, 4, dtype=torch.int32),
                           extra=extra, max_seq=16)
            lg, _ = decode_step(cfg, p, torch.ones(1, 1, dtype=torch.int32),
                                c, 12)
            assert bool(torch.isfinite(lg).all())
        # the paper's simulator
        from repro_torch.core import MursConfig as CoreMurs
        from repro_torch.core.spark_sim import make_grep, run_service
        m = run_service([make_grep()], heap_gb=4.0, murs=CoreMurs())
        assert m.jobs["grep"].finish_time > 0
        # the front door over a cluster that checkpoints, crashes, restores
        import tempfile
        from repro_torch.serve import (
            ClusterConfig, FrontDoor, FrontDoorConfig, ServingCluster,
            TenantProfile, poisson_trace,
        )
        cfg = ARCHS["internlm2-1.8b"].smoke()
        params = init_model(cfg, 0, device="cpu")
        with tempfile.TemporaryDirectory() as d:
            cl = ServingCluster(cfg, params, ClusterConfig(
                engine=lambda: EngineConfig(
                    n_slots=2, max_seq=64, hbm_capacity_bytes=1e9,
                    device="cpu"),
                checkpoint_every_ticks=3, checkpoint_dir=d))
            door = FrontDoor(cl, FrontDoorConfig(buckets={{"b": (0.0, 1.0)}}))
            for a in poisson_trace([TenantProfile("a"), TenantProfile("b")],
                                   rate_per_tick=1.0, n_requests=8, seed=0):
                door.submit(a.request)
            for _ in range(4):
                door.step()
            assert cl.ckpt_saved >= 1
            cl.crash_replica(0)
            rep = door.run(max_ticks=200)
        assert rep.completed == rep.extras["admitted"] >= 1
        assert rep.extras["rate_limited"] >= 1
        assert cl.ckpt_restored_requests >= 1
        # the training loop: two steps, a checkpoint, a resume
        from repro_torch.configs import SHAPES
        from repro_torch.train import Trainer, TrainerConfig
        with tempfile.TemporaryDirectory() as d:
            for steps in (2, 3):
                out = Trainer(ARCHS["internlm2-1.8b"].smoke(),
                              SHAPES["train_4k"], TrainerConfig(
                                  steps=steps, ckpt_every=2, log_every=1,
                                  ckpt_dir=d, device="cpu"),
                              batch=2, seq=16).run()
                assert out["final_step"] == steps
        bad = sorted(m for m in sys.modules
                     if m == "repro" or m.startswith("repro.")
                     or m in ("jax", "msgpack")
                     and sys.modules[m] is not None)
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
