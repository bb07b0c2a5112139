"""A temporary checkout of the benchmark at test size: the real metric
readers, small copies of the configurations and mixes under new names,
and a BENCHMARK.json of new cells over them, all made as new files."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, vocab_size=512)
#: limits at this size, from its readings (see test_gpu_bench_check.py);
#: as at full size, the MoE model also compares its median leaf's first
#: gradient direction and its choices of experts, and neither model its
#: loss
TINY_LIMITS = {
    "dense": {"serve": {"max_logit_gap": 0.1},
              "train": {"grad_norm_gap": 0.004, "change_norm_gap": 0.25}},
    "moe": {"train": {"grad_norm_gap": 0.006, "change_norm_gap": 0.25,
                      "grad_dir_gap": 0.07, "route_gap": 0.15}}}


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_files(root: Path) -> dict:
    """Write the test-size files under ``root``; returns the spec."""
    src = REPO / "gpu_bench"
    (root / "gpu_bench").mkdir(parents=True)
    shutil.copytree(src / "metrics", root / "gpu_bench" / "metrics")
    for d in ("configs", "traffic"):
        (root / "gpu_bench" / d).mkdir()
    dense = _json(src / "configs" / "internlm2-1.8b.json")
    dense["model"].update(SMALL, intermediate_size=128)
    dense["serve"].update(n_slots=4, max_seq=160, pool_tokens=300,
                          prefill_chunk_tokens=96, max_prefix_snapshots=8)
    moe = _json(src / "configs" / "granite-moe-3b-a800m.json")
    moe["model"].update(SMALL, intermediate_size=32, num_local_experts=8,
                        num_experts_per_tok=2)
    dense["check"] = copy.deepcopy(TINY_LIMITS["dense"])
    moe["check"] = copy.deepcopy(TINY_LIMITS["moe"])
    mixes = {}
    for name in ("murs-two-group", "chat"):
        mx = _json(src / "traffic" / f"{name}.json")
        mx.update(rate_per_s=4, warm_s=1, grace_s=2, slice_s=0.5,
                  requests=200)
        for g in mx["groups"]:
            if g["prompt"]["dist"] == "lognormal":
                g["prompt"].update(min=8, max=64, median=24)
            else:
                g["prompt"].update(min=16, max=48)
            g["output"].update(min=2, max=40, median=8)
            if "shared_prefix" in g:
                g["shared_prefix"]["tokens"] = 16
        mixes["tiny-" + name] = mx
    job = _json(src / "traffic" / "train-b4-s2k.json")
    job.update(batch=4, seq=32)
    mixes["tiny-train"] = job
    (root / "gpu_bench" / "configs" / "tiny-dense.json").write_text(
        json.dumps(dense))
    (root / "gpu_bench" / "configs" / "tiny-moe.json").write_text(
        json.dumps(moe))
    for name, mx in mixes.items():
        (root / "gpu_bench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mx))
    spec = _json(REPO / "BENCHMARK.json")
    cells = {"serve-internlm2-murs": ("tiny-murs", "tiny-dense",
                                      "tiny-murs-two-group"),
             "serve-internlm2-chat": ("tiny-chat", "tiny-dense",
                                      "tiny-chat"),
             "train-granite-s2k": ("tiny-moe-train", "tiny-moe",
                                   "tiny-train"),
             "train-internlm2-s2k": ("tiny-dense-train", "tiny-dense",
                                     "tiny-train")}
    spec["workloads"] = [dict(w, name=cells[w["name"]][0],
                              config=cells[w["name"]][1],
                              traffic=cells[w["name"]][2])
                         for w in spec["workloads"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [cells[w][0] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    tiny_files(root)
    return root


def run_cell(root, cell, seed=2**31 + 5, trace=False, control=False,
             seconds=3):
    from gpu_bench import run

    return run.execute(root, cell, seed, seconds, trace, "cpu", control)[0]
