"""The port's dry-run and the dry-run half of its roofline analysis, on the
CPU.

- ``model_flops`` and ``memory_traffic_bytes`` equal the JAX package's
  for every (arch × shape) cell, within 1e-12 relative (the same float
  arithmetic on the same config numbers; the bytes through each
  package's own ``serve.kv_cache`` helpers).
- Two cells through the CLI in a subprocess (a decode cell on 16×16 and
  an MoE decode cell on 2×16×16): exit 0, a record with the JAX
  package's keys and ``mesh_axes``; collectives as a dict of
  ``{count, bytes}`` per kind under the JAX names, each split by the
  mesh axes it spans (``axes``, summing to the kind's totals), and an
  integer temp memory (the per-device program's, ``test_torch_dryrun_
  program.py``); FLOPs per device that cover the weights' 2·N a token
  over the chips; and per-device argument bytes equal to the sum, over
  every parameter and batch leaf, of its bytes over the mesh factors
  its fitted spec names — worked out here from the specs alone, with
  no DTensor.  A second run reads the cache.
- A failing cell is recorded with its error and ``main`` exits 1.
- A record with ``null`` collectives has no collective term: the
  bottleneck and the step time come from compute and memory, and the
  table prints "–"; a record without ``axes`` prices its bytes at
  NVLink's rate.
- The collective term prices each mesh axis's bytes by the link its
  groups cross: on a 2×4 mesh both axes stay in one 8-card node
  (NVLink), on 16×16 both cross nodes (InfiniBand), and on 2×16×16 the
  pod axis too, whatever its size (a known answer worked out by hand).
"""

import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.roofline import analysis as janalysis  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.dist.presets import batch_shardings  # noqa: E402
from repro_torch.dist.sharding import param_shardings  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.specs import input_specs, model_state_specs  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
CELLS = [(a, s) for a, c in ARCHS.items() for s in c.applicable_shapes]
RECORD_KEYS = {"arch", "shape", "mesh", "kind", "variant", "params",
               "active_params", "lower_s", "compile_s", "cost", "memory",
               "collectives", "mesh_axes"}
JAX_KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute"}


@pytest.fixture
def fake_group():
    tmesh.destroy_mesh_group()
    yield
    tmesh.destroy_mesh_group()


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_terms_equal_jax(arch, shape):
    for fn in ("model_flops", "memory_traffic_bytes"):
        got = getattr(analysis, fn)(arch, shape)
        want = getattr(janalysis, fn)(arch, shape)
        assert math.isclose(got, want, rel_tol=1e-12), (fn, got, want)
    assert analysis.CHIPS == janalysis.CHIPS


def _expected_arg_bytes(arch, shape_name, multi_pod):
    """Per-device bytes of every argument, from the fitted specs and the
    mesh's axis sizes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, shape = ARCHS[arch], SHAPES[shape_name]
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    rules, p_rules = dryrun.cell_rules(cfg, shape, mesh, "baseline")
    with FakeTensorMode():
        specs = input_specs(cfg, shape)
        params = model_state_specs(cfg, with_opt=False)
    total = 0
    for tree, shardings in ((params, param_shardings(params, p_rules)),
                            (specs, batch_shardings(cfg, rules, specs))):
        for t, s in zip(tree_leaves(tree), tree_leaves(shardings)):
            n = t.numel() * t.element_size()
            for e in s.spec:
                for axis in ((e,) if isinstance(e, str) else e or ()):
                    n //= sizes[axis]
            total += n
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("internlm2-1.8b", "decode_32k", False),
    ("granite-moe-3b-a800m", "decode_32k", True),
])
def test_cli_cell(tmp_path, fake_group, arch, shape, multi_pod):
    out = tmp_path / "dr"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--out", str(out)]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dry-run: 1 ok, 0 failed, 0 n/a" in proc.stdout
    mesh = "2x16x16" if multi_pod else "16x16"
    path = out / f"{arch}__{shape}__{mesh}.json"
    rec = json.loads(path.read_text())
    assert set(rec) == RECORD_KEYS
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["kind"],
            rec["variant"]) == (arch, shape, mesh, "decode", "baseline")
    coll = rec["collectives"]
    assert coll and set(coll) <= JAX_KINDS, coll
    names = {n for n, _ in rec["mesh_axes"]}
    for entry in coll.values():
        assert entry["count"] > 0 and entry["bytes"] > 0
        assert all(set(a.split("+")) <= names for a in entry["axes"])
        for key in ("count", "bytes"):
            assert sum(a[key] for a in entry["axes"].values()) == entry[key]
    temp = rec["memory"]["temp_size_in_bytes"]
    assert isinstance(temp, int) and temp > 0
    assert rec["memory"]["argument_size_in_bytes"] == _expected_arg_bytes(
        arch, shape, multi_pod)
    # the counted FLOPs cover at least the weights' 2·N per token
    flops_global = rec["cost"]["flops"] * analysis.CHIPS[mesh]
    cfg = ARCHS[arch]
    assert flops_global >= 2 * cfg.active_param_count() \
        * SHAPES[shape].global_batch * 0.9
    again = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                           env=env, timeout=300)
    assert again.returncode == 0 and "[skip]" in again.stdout


def test_failing_cell_is_recorded_and_main_exits_1(tmp_path, fake_group,
                                                    capsys):
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "no-such-arch", "--shape", "train_4k",
                     "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads(
        (tmp_path / "no-such-arch__train_4k__16x16.json").read_text())
    assert rec["error"].startswith("KeyError")
    assert "dry-run: 0 ok, 1 failed, 0 n/a" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()  # main destroyed it


def test_null_collectives_have_no_term():
    rec = {"arch": "internlm2-1.8b", "shape": "decode_32k", "mesh": "16x16",
           "kind": "decode", "cost": {"flops": 1e10},
           "memory": {"argument_size_in_bytes": 1,
                      "temp_size_in_bytes": None},
           "collectives": None}
    cell = analysis.load_cell(rec)
    assert cell.collective_s is None
    assert cell.bottleneck == "memory"
    assert cell.step_time_s == max(cell.compute_s, cell.memory_s)
    row = analysis.markdown_table([cell]).splitlines()[2]
    assert row.split("|")[5].strip() == "–"
    assert analysis.load_cell({"skipped": True}) is None
    with_coll = analysis.load_cell(
        rec | {"collectives": {"all-gather": {"count": 1, "bytes": 9e12}}})
    assert with_coll.bottleneck == "collective"
    assert with_coll.collective_s == 9e12 / analysis.NVLINK_BW


def test_collectives_priced_by_link():
    gb = 2**30
    coll = {"all-gather": {"count": 2, "bytes": 3 * gb, "axes": {
        "data": {"count": 1, "bytes": gb},
        "model": {"count": 1, "bytes": 2 * gb}}},
        "all-reduce": {"count": 1, "bytes": gb, "axes": {
            "pod": {"count": 1, "bytes": gb}}}}
    nv, ib = analysis.NVLINK_BW, analysis.IB_BW
    # 2×4: model's 4 ranks are adjacent, data's 2 are 4 apart: one node
    close = lambda a, b: math.isclose(a, b, rel_tol=1e-12)  # noqa: E731
    assert close(analysis.collective_seconds(
        {"all-gather": coll["all-gather"]},
        [["data", 2], ["model", 4]]), 3 * gb / nv)
    # 16×16: model's 16 adjacent ranks span 2 nodes; data's, 16 apart, 16
    assert close(analysis.collective_seconds(
        {"all-gather": coll["all-gather"]},
        [["data", 16], ["model", 16]]), 3 * gb / ib)
    # 2×16×16: the pod axis's 2 ranks are 256 apart — InfiniBand too
    axes = [["pod", 2], ["data", 16], ["model", 16]]
    assert analysis.link_bw(axes, "pod") == ib
    assert close(analysis.collective_seconds(coll, axes), 4 * gb / ib)
    # an 8-card model axis alone fits one node
    assert analysis.link_bw([["data", 32], ["model", 8]], "model") == nv
    assert analysis.link_bw([["data", 32], ["model", 8]], "data") == ib
    # a group over a flattened 2×4 (data, model) spans 8 ranks: one node
    assert analysis.link_bw([["data", 2], ["model", 4]], "data+model") == nv
    assert analysis.link_bw([["data", 4], ["model", 4]], "data+model") == ib
    rec = {"arch": "internlm2-1.8b", "shape": "train_4k", "mesh": "16x16",
           "kind": "train", "cost": {"flops": 1e10},
           "memory": {"temp_size_in_bytes": 1},
           "collectives": {"all-gather": coll["all-gather"]},
           "mesh_axes": [["data", 16], ["model", 16]]}
    assert close(analysis.load_cell(rec).collective_s, 3 * gb / ib)
