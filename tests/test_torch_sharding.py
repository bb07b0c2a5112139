"""The port's SPMD rules against the JAX package's, on the CPU.

The JAX reference runs once, in a module-scoped subprocess with 512
placeholder CPU devices (``--xla_force_host_platform_device_count``, which
must be set before JAX starts, so not in this process).  For both
production meshes it dumps, for every architecture × applicable shape ×
variant (``baseline``, ``zero1``, ``serve_v2``, ``repembed``): the
``arch_overrides``, the fitted spec of every parameter leaf (and of the
moments, under the rules ``build_cell`` gives them) and of every batch
leaf, with each leaf's shape.  The port resolves the same cells over
``DeviceMesh`` es on torch's fake process group; the two must be equal
path for path, over the same set of paths.

Then what ``tests/test_dist_integration.py`` holds of the JAX package:
``shard`` is the identity without rules, an unknown axis raises, a smoke
train step under 1×1 rules (gloo) equals the plain step (here bit for
bit) and the JAX package's loss within ``BF16_LOSS_ATOL`` (0.02, as
``tests/test_torch_train.py`` states for a bf16 smoke loss), and every
cell's batch resolves on the debug mesh; and what
``tests/test_substrate.py`` holds of ``elastic_reshard``, on a gloo 1×1
mesh and on the fake 16×16 mesh.  Every process group a test sets up is
destroyed by a fixture.
"""

import json
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import models as jm  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.dist.sharding import path_str as j_path_str  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.checkpoint.checkpointing import restore, save  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.dist.fault import elastic_reshard  # noqa: E402
from repro_torch.dist.presets import (  # noqa: E402
    arch_overrides,
    batch_shardings,
)
from repro_torch.dist.sharding import (  # noqa: E402
    current_rules,
    make_rules,
    param_shardings,
    param_spec_for_path,
    path_str,
    shard,
    use_rules,
)
from repro_torch.launch import dryrun, mesh as tmesh  # noqa: E402
from repro_torch.launch.specs import input_specs, model_state_specs  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_leaves,
    tree_map,
    tree_map_with_path,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PARITY_VARIANTS = ("baseline", "zero1", "serve_v2", "repembed")
BF16_LOSS_ATOL = 0.02  # a bf16 smoke loss, as test_torch_train.py states

#: the JAX package's side of every cell, as build_cell resolves it
JAX_DUMP = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, SRC)
    import jax
    from repro.configs import ARCHS, SHAPES
    from repro.dist.presets import arch_overrides, batch_shardings
    from repro.dist.sharding import make_rules, param_shardings, path_str
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import input_specs, model_state_specs

    def specs_of(shardings, values):
        out = {}
        def one(kp, s, v):
            out[path_str(kp)] = [list(v.shape),
                                 [list(e) if isinstance(e, tuple) else e
                                  for e in s.spec]]
        jax.tree_util.tree_map_with_path(one, shardings, values)
        return out

    params = {a: model_state_specs(c, with_opt=False)
              for a, c in ARCHS.items()}
    dump = {}
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        for arch, cfg in ARCHS.items():
            for sname in cfg.applicable_shapes:
                shape = SHAPES[sname]
                specs = input_specs(cfg, shape)
                for variant in VARIANTS:
                    # build_cell's overrides and rules, verbatim
                    overrides = arch_overrides(cfg, mesh, shape)
                    base = dict(overrides)
                    if variant == "serve_v2":
                        overrides["fsdp"] = None
                        overrides["kv_seq"] = "model"
                        if (cfg.moe is not None
                                and overrides.get("expert", "x") is not None):
                            overrides["expert_mlp"] = "data"
                    if variant == "repembed":
                        overrides["vocab"] = None
                    rules = make_rules(mesh, overrides=overrides)
                    p_rules = rules
                    if shape.kind == "train" and variant == "zero1":
                        p_rules = make_rules(
                            mesh, overrides=overrides | {"fsdp": None})
                    p = params[arch]
                    cell = {
                        "overrides": {k: list(v) if isinstance(v, tuple)
                                      else v for k, v in base.items()},
                        "params": specs_of(param_shardings(p, p_rules), p),
                        "batch": specs_of(
                            batch_shardings(cfg, rules, specs), specs),
                    }
                    if shape.kind == "train":
                        cell["moments"] = specs_of(
                            param_shardings(p, rules), p)
                    key = "|".join((str(multi_pod), arch, sname, variant))
                    dump[key] = cell
    json.dump(dump, sys.stdout)
    """
)


def _jsonable(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def jax_specs():
    script = (f"SRC = {SRC!r}\nVARIANTS = {PARITY_VARIANTS!r}\n"
              + JAX_DUMP)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


@pytest.fixture
def fake_group():
    """The fake process group the production meshes stand on, destroyed
    after the test."""
    tmesh.destroy_mesh_group()
    yield
    tmesh.destroy_mesh_group()


@pytest.fixture
def gloo_mesh():
    """A 1×1 ("data", "model") mesh over a one-rank gloo group, destroyed
    after the test."""
    tmesh.destroy_mesh_group()
    yield tmesh.make_debug_mesh("cpu")
    tmesh.destroy_mesh_group()


def _by_path(tree):
    out = {}
    tree_map_with_path(lambda p, x: out.__setitem__(path_str(p), x), tree)
    return out


def _port_specs(shardings, values):
    specs, shapes = _by_path(shardings), _by_path(values)
    assert set(specs) == set(shapes)
    return {path: [list(shapes[path].shape), _jsonable(s.spec)]
            for path, s in specs.items()}


def test_port_specs_equal_jax_path_for_path(jax_specs, fake_group):
    """Both meshes, every arch × applicable shape × the four variants:
    overrides, every parameter (and moment) leaf's fitted spec and every
    batch leaf's, with their shapes, equal to the JAX package's over the
    same set of paths."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        params = {a: model_state_specs(c, with_opt=False)
                  for a, c in ARCHS.items()}
    seen = set()
    for multi_pod in (False, True):
        mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
        assert mesh.shape == ((2, 16, 16) if multi_pod else (16, 16))
        for arch, cfg in ARCHS.items():
            for sname in cfg.applicable_shapes:
                shape = SHAPES[sname]
                with FakeTensorMode():
                    specs = input_specs(cfg, shape)
                for variant in PARITY_VARIANTS:
                    key = "|".join((str(multi_pod), arch, sname, variant))
                    want = jax_specs[key]
                    rules, p_rules = dryrun.cell_rules(cfg, shape, mesh,
                                                       variant)
                    p = params[arch]
                    got = {
                        "overrides": {k: list(v) if isinstance(v, tuple)
                                      else v for k, v in
                                      arch_overrides(cfg, mesh,
                                                     shape).items()},
                        "params": _port_specs(param_shardings(p, p_rules), p),
                        "batch": _port_specs(
                            batch_shardings(cfg, rules, specs), specs),
                    }
                    if shape.kind == "train":
                        got["moments"] = _port_specs(
                            param_shardings(p, rules), p)
                    assert set(got) == set(want), key
                    for part in got:
                        assert set(got[part]) == set(want[part]), (key, part)
                        assert got[part] == want[part], (key, part)
                    seen.add(key)
    assert seen == set(jax_specs)


def test_tree_paths_join_as_jax_joins_them():
    """Every leaf path of zamba2's params tree (the stacked unit, the
    suffix list, the shared body) and its AdamW state (a NamedTuple:
    "m/layers/b0/...") joins to the JAX package's string."""
    from repro_torch.models import init_model

    name = "zamba2-1.2b"
    want = set()
    jax.tree_util.tree_map_with_path(
        lambda kp, x: want.add((j_path_str(kp), tuple(x.shape))),
        jax.eval_shape(lambda: (lambda p: (p, jadamw.init(p)))(
            jm.init_model(JARCHS[name].smoke(), jax.random.PRNGKey(0)))))
    tp = init_model(ARCHS[name].smoke(), device="cpu")
    got = set()
    tree_map_with_path(lambda p, x: got.add((path_str(p), tuple(x.shape))),
                       (tp, tadamw.init(tp)))
    assert got == want
    assert any(p.startswith("1/m/layers/") for p, _ in got)
    assert any(p.startswith("0/suffix/0/") for p, _ in got)


def test_shard_is_identity_without_rules():
    x = torch.ones(2, 3)
    assert current_rules() is None
    assert shard(x, ("batch", None)) is x


def test_shard_unknown_logical_axis_fails_loudly(gloo_mesh):
    rules = make_rules(gloo_mesh)
    with use_rules(rules):
        assert current_rules() is rules
        with pytest.raises(KeyError, match="unknown logical axis"):
            shard(torch.ones(2), ("batcj",))
        x = torch.ones(2, 3)
        assert shard(x, ("batch", "embed")) is x  # one card holds it whole
    assert current_rules() is None


def test_shard_redistributes_a_dtensor(gloo_mesh):
    """Under rules a DTensor moves to the pin's placements (its values
    unchanged); without rules it is returned as it is."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = torch.arange(12.0).reshape(3, 4)
    d = distribute_tensor(x, gloo_mesh, (Replicate(), Replicate()))
    assert shard(d, ("batch", "mlp")) is d
    with use_rules(make_rules(gloo_mesh)):
        out = shard(d, ("batch", "mlp"))
    assert out.placements == (Shard(0), Shard(1))
    torch.testing.assert_close(out.full_tensor(), x, rtol=0, atol=0)


def test_placements_follow_the_mesh_order(fake_group):
    """Batch over ("pod", "data") shards dim 0 on both mesh dims; an entry
    listing its axes against the mesh's order raises; a spec entry equal
    to JAX's PartitionSpec entries."""
    from torch.distributed.tensor import Replicate, Shard

    rules = make_rules(tmesh.make_production_mesh(multi_pod=True))
    s = rules.sharding(("batch", "seq", "vocab"))
    assert s.spec == (("pod", "data"), None, "model")
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert rules.placements((None, "data")) == (Replicate(), Shard(1),
                                                Replicate())
    with pytest.raises(ValueError, match="out of the mesh's order"):
        rules.placements((("data", "pod"),))


def test_param_rules_and_dedup(gloo_mesh):
    """As tests/test_substrate.py holds the JAX package's rules."""
    rules = make_rules(gloo_mesh)
    assert param_spec_for_path("layers/b0/attn/wq", rules, 3) == (
        None, "data", "model")
    assert param_spec_for_path("embed/tokens", rules, 2) == ("model", "data")
    assert param_spec_for_path("final_ln", rules, 1) == ()
    assert rules.entries(("heads", "mlp")) == ("model", None)


def test_train_step_under_rules_matches_unsharded(gloo_mesh):
    """internlm2 smoke (bf16), one step from the JAX package's parameters:
    under 1×1 rules, on tensors placed by elastic_reshard, the loss, grad
    norm and every updated leaf equal the plain step's bit for bit; the
    loss is the JAX package's within BF16_LOSS_ATOL."""
    from repro.configs.base import ShapeConfig

    jcfg = JARCHS["internlm2-1.8b"].smoke()
    cfg = ARCHS["internlm2-1.8b"].smoke()
    shape = ShapeConfig("t", 16, 4, "train")
    rules = make_rules(gloo_mesh,
                       overrides=arch_overrides(cfg, gloo_mesh, shape))
    jp = jm.init_model(jcfg, jax.random.PRNGKey(0))
    p_np = jax.tree_util.tree_map(np.asarray, jp)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (4, 16), dtype=np.int32),
             "labels": rng.integers(0, cfg.vocab, (4, 16), dtype=np.int32)}
    _, _, j_metrics = jax.jit(jstep.make_train_step(
        jcfg, jadamw.AdamWConfig(lr=1e-3)))(jp, jadamw.init(jp), batch)

    opt = tadamw.AdamWConfig(lr=1e-3)
    t_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    plain = params_from_numpy(p_np, "cpu")
    p_plain, s_plain, m_plain = tstep.make_train_step(cfg, opt)(
        plain, tadamw.init(plain), dict(t_batch))
    placed = elastic_reshard(params_from_numpy(p_np, "cpu"), rules)
    params = tree_map(lambda d: d.to_local(), placed)
    with use_rules(rules):
        p_rules, s_rules, m_rules = tstep.make_train_step(cfg, opt)(
            params, tadamw.init(params), dict(t_batch))
    for k in ("loss", "grad_norm"):
        assert torch.equal(m_rules[k], m_plain[k]), k
    for a, b in zip(tree_leaves((p_rules, s_rules)),
                    tree_leaves((p_plain, s_plain))):
        assert torch.equal(a, b)
    assert abs(float(m_rules["loss"]) - float(j_metrics["loss"])) \
        <= BF16_LOSS_ATOL


def test_arch_overrides_cover_all_configs(gloo_mesh):
    """Every (arch × applicable shape) cell resolves to rules whose batch
    shardings cover every input leaf (smoke shapes, the debug mesh)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for cfg in ARCHS.values():
        for shape_name in cfg.applicable_shapes:
            shape = SHAPES[shape_name]
            rules = make_rules(gloo_mesh, overrides=arch_overrides(
                cfg, gloo_mesh, shape))
            with FakeTensorMode():
                specs = input_specs(cfg.smoke(), shape)
            shardings = batch_shardings(cfg.smoke(), rules, specs)
            assert len(tree_leaves(shardings)) == len(tree_leaves(specs))
            for s in tree_leaves(shardings):
                assert s.mesh is gloo_mesh
                assert len(s.placements) == 2


def _ckpt_tree(n):
    return {
        "layers": {"b0": {"mlp": {
            "gate": torch.arange(float(n * n)).reshape(n, n)}}},
        "final_ln": torch.ones(n),
    }


def test_elastic_reshard_restores_onto_a_one_card_mesh(gloo_mesh):
    """A checkpoint restores onto the 1×1 mesh: values unchanged, the gate
    under the mlp rule (fsdp→data, mlp→model), the norm replicated."""
    from torch.distributed.tensor import Replicate, Shard

    tree = _ckpt_tree(8)
    with tempfile.TemporaryDirectory() as d:
        save(os.path.join(d, "ckpt_1.ckpt"), tree, step=1)
        restored, _ = restore(os.path.join(d, "ckpt_1.ckpt"), tree)
    out = elastic_reshard(restored, make_rules(gloo_mesh))
    gate = out["layers"]["b0"]["mlp"]["gate"]
    torch.testing.assert_close(gate.full_tensor(),
                               tree["layers"]["b0"]["mlp"]["gate"],
                               rtol=0, atol=0)
    assert gate.placements == (Shard(0), Shard(1))
    assert out["final_ln"].placements == (Replicate(), Replicate())


def test_elastic_reshard_onto_the_production_mesh(fake_group):
    """On the fake 16×16 mesh a 32×32 gate splits 16 × 16 ways (local
    2×2); an 8×8 one cannot, so fit replicates it."""
    from torch.distributed.tensor import Replicate, Shard

    rules = make_rules(tmesh.make_production_mesh())
    big = elastic_reshard(_ckpt_tree(32), rules)
    gate = big["layers"]["b0"]["mlp"]["gate"]
    assert gate.placements == (Shard(0), Shard(1))
    assert tuple(gate.to_local().shape) == (2, 2)
    assert tuple(gate.shape) == (32, 32)
    small = elastic_reshard(_ckpt_tree(8), rules)["layers"]["b0"]["mlp"]
    assert small["gate"].placements == (Replicate(), Replicate())
    assert tuple(small["gate"].to_local().shape) == (8, 8)
