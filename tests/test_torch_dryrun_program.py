"""The dry-run's per-device program (``repro_torch.launch.dryrun``) on
the CPU: a step run on DTensors of fake local shards under
``ProgramCounter``.

- **Analytic cases** on a fake 2×4 ("data", "model") mesh, bf16, every
  number worked out by hand from the local shapes:
  - a column-parallel projection x [4, 8, 16] (batch over data) @ w
    [16, 32] (columns over model): no collective; the output [2, 8, 8]
    is 256 B and is the peak, so temp is 0;
  - a row-parallel projection h [4, 8, 32] (batch over data, columns
    over model) @ w [32, 16] (rows over model), pinned to the residual:
    one all-reduce over model of the [2, 8, 16] partial, 512 B; the
    peak holds the partial and its sum, 1,024 B, of which the 512 B
    output is not temp: temp 512 B;
  - an FSDP weight w [16, 32] (rows over data, columns over model)
    gathered at use, then its gradient: one all-gather over data whose
    result is the [16, 8] gathered block, 256 B, and one reduce-scatter
    over data of the [8, 8] gradient block, 128 B;
  - a vocab-sharded embedding table [32, 16] (vocab over model, d over
    data) looked up by tokens [4, 8] (batch over data), then its
    gradient: the fsdp all-gather over data of the [8, 16] block
    (256 B), the all-reduce over model of the [2, 8, 16] partial lookup
    (512 B: each device holds a quarter of the vocabulary), and the
    reduce-scatter over data of the [8, 8] gradient block (128 B).
- **Against the JAX package**: smoke internlm2 and granite-moe, a train
  step (B 8 × S 64) and a decode step (B 8 over a cache of 64), on a
  (2, 4) mesh.  JAX compiles the cells in a subprocess with 8 host
  devices (``--xla_force_host_platform_device_count``) through its own
  ``make_rules``, ``arch_overrides``, ``param_shardings`` and
  ``make_train_step`` / ``decode_step``, as ``repro.launch.dryrun``
  builds a cell (on a mesh of ``Auto`` axes, which JAX 0.9's
  ``make_mesh`` no longer makes by default); bytes from
  ``repro.launch.dryrun.collective_bytes`` and ``memory_analysis``.  The
  port runs the same cells on a fake 2×4 mesh.  In the train cells
  both programs must gather every fsdp-sharded parameter and reduce
  every such gradient: all-gather bytes, and all-reduce plus
  reduce-scatter bytes, each at least what the parameters alone force,
  worked out from their specs (one layer of a stacked leaf, since JAX's
  HLO text counts a collective in the scanned unit's loop body once);
  in the decode cells the port must (it gathers each weight at use),
  while XLA sums partial products for granite-moe's expert weights
  (50,144 B gathered against the 74,240 B a gather of every weight
  forces).  The two programs' total collective bytes must agree within
  4×.  Per kind, bytes (port / JAX, ratio), read on this CPU:

  ==================  ==================  ==================  ===========  ==========  =====
  cell                all-gather          all-reduce          reduce-sc.   all-to-all  total
  ==================  ==================  ==================  ===========  ==========  =====
  internlm2 train     114,688 / 116,736   406,548 / 497,680   36,864 / 0   0 / 65,536  0.82
                      (0.98)              (0.82)
  internlm2 decode    73,728 / 73,760     2,560 / 3,072       0 / 0        0 / 512     0.99
                      (1.00)              (0.83)
  granite-moe train   788,480 / 314,368   341,012 / 699,412   75,776 / 0   0 / 65,536  1.12
                      (2.51)              (0.49)
  granite-moe decode  159,488 / 50,144    1,536 / 6,304       0 / 0        0 / 1,024   2.80
                      (3.18)              (0.24)
  ==================  ==================  ==================  ===========  ==========  =====

  JAX also has one 1,024 B collective-permute in each train cell.  The
  kinds differ where XLA chose other collectives (it reduces gradients
  by all-reduce on this backend, never reduce-scatter); granite-moe
  decode's all-reduce ratio, 1 : 4.1, is ROADMAP Queue 3's record.
- **Bit-equality of the plain path**: a microbatched train step, and a
  decode step after a prefill, of every architecture (smoke) on
  DTensors over a 1×1 gloo mesh, inside ``use_rules``, give the same
  loss, grad norm, parameters, moments, logits and caches, bit for bit,
  as the same step on plain tensors.

Every process group a test sets up is destroyed by a fixture.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (  # noqa: E402
    DTensor,
    Replicate,
    Shard,
)

from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist.presets import arch_overrides, batch_shardings  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    gather_fsdp,
    make_rules,
    param_shardings,
    path_str,
    shard,
    use_rules,
)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.dryrun import ProgramCounter, program_cell  # noqa: E402
from repro_torch.launch.specs import model_state_specs  # noqa: E402
from repro_torch.models import decode_step, init_model, prefill  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.tree import (  # noqa: E402
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_unflatten,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
BF16 = torch.bfloat16

#: (arch, kind, batch, seq) of the cells compared with the JAX package
JAX_CELLS = (("internlm2-1.8b", "train", 8, 64),
             ("internlm2-1.8b", "decode", 8, 64),
             ("granite-moe-3b-a800m", "train", 8, 64),
             ("granite-moe-3b-a800m", "decode", 8, 64))
#: the most the two programs' total collective bytes may differ by
TOTAL_RATIO = 4.0

#: the JAX package's side: each cell compiled as repro.launch.dryrun
#: builds one, on a (2, 4) mesh of Auto axes
JAX_PROGRAMS = textwrap.dedent(
    """
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, SRC)
    import jax
    from repro.configs import ARCHS
    from repro.configs.base import ShapeConfig
    from repro.dist.presets import arch_overrides, batch_shardings
    from repro.dist.sharding import make_rules, param_shardings, use_rules
    from repro.launch.dryrun import _memory_dict, collective_bytes
    from repro.launch.specs import input_specs, model_state_specs
    from repro.models import decode_step
    from repro.optim import adamw
    from repro.train.train_step import make_train_step

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch, kind, batch, seq in CELLS:
        cfg = ARCHS[arch].smoke()
        shape = ShapeConfig(kind, seq, batch, kind)
        rules = make_rules(mesh, overrides=arch_overrides(cfg, mesh, shape))
        specs = input_specs(cfg, shape)
        b_sh = batch_shardings(cfg, rules, specs)
        with use_rules(rules):
            if kind == "train":
                params, opt = model_state_specs(cfg)
                p_sh = param_shardings(params, rules)
                o_sh = adamw.AdamWState(step=rules.sharding(()), m=p_sh,
                                        v=p_sh)
                fn = jax.jit(make_train_step(cfg, adamw.AdamWConfig()),
                             in_shardings=(p_sh, o_sh, b_sh),
                             donate_argnums=(0, 1))
                lowered = fn.lower(params, opt, specs)
            else:
                params = model_state_specs(cfg, with_opt=False)
                p_sh = param_shardings(params, rules)
                fn = jax.jit(
                    lambda p, t, c, pos: decode_step(cfg, p, t, c, pos),
                    in_shardings=(p_sh, b_sh["tokens"], b_sh["caches"],
                                  b_sh["pos"]),
                    donate_argnums=(2,))
                lowered = fn.lower(params, specs["tokens"], specs["caches"],
                                   specs["pos"])
        compiled = lowered.compile()
        out[f"{arch}|{kind}"] = {
            "collectives": collective_bytes(compiled.as_text()),
            "memory": _memory_dict(compiled)}
    json.dump(out, sys.stdout)
    """
)


@pytest.fixture
def mesh24():
    """A fake 2×4 ("data", "model") mesh, its group destroyed after."""
    tmesh.destroy_mesh_group()
    yield tmesh.make_fake_mesh((2, 4))
    tmesh.destroy_mesh_group()


@pytest.fixture
def gloo_mesh():
    """A 1×1 mesh over a one-rank gloo group, destroyed after."""
    tmesh.destroy_mesh_group()
    yield tmesh.make_debug_mesh("cpu")
    tmesh.destroy_mesh_group()


# ------------------------------------------------------------ analytic
def _column(x, w):
    return shard(torch.matmul(x, w), ("batch", "seq", "mlp"))


def _row(h, w):
    return shard(torch.matmul(h, w), ("batch", "seq", "embed"))


def _fsdp(x, w):
    y = torch.matmul(x, gather_fsdp(w))
    return torch.autograd.grad(y, w, torch.ones_like(y))[0]


def _embedding(table, tokens):
    y = transformer._embed({"embed": {"tokens": table}}, tokens)
    return torch.autograd.grad(y, table, torch.ones_like(y))[0]


S, R = Shard, Replicate
#: case → (step, [(local shape, placements, dtype, needs grad)],
#:         {kind: (count, bytes, {axis: bytes})}, temp bytes or None)
ANALYTIC = {
    "column": (_column, [((2, 8, 16), (S(0), R()), BF16, False),
                         ((16, 8), (R(), S(1)), BF16, False)], {}, 0),
    "row": (_row, [((2, 8, 8), (S(0), S(2)), BF16, False),
                   ((8, 16), (R(), S(0)), BF16, False)],
            {"all-reduce": (1, 512, {"model": 512})}, 512),
    "fsdp": (_fsdp, [((2, 8, 16), (S(0), R()), BF16, False),
                     ((8, 8), (S(0), S(1)), BF16, True)],
             {"all-gather": (1, 256, {"data": 256}),
              "reduce-scatter": (1, 128, {"data": 128})}, None),
    "embedding": (_embedding, [((8, 8), (S(1), S(0)), BF16, True),
                               ((2, 8), (S(0), R()), torch.int32, False)],
                  {"all-gather": (1, 256, {"data": 256}),
                   "all-reduce": (1, 512, {"model": 512}),
                   "reduce-scatter": (1, 128, {"data": 128})}, None),
}


@pytest.mark.parametrize("case", sorted(ANALYTIC))
def test_analytic_collectives_and_temp(mesh24, case):
    step, args, want, temp = ANALYTIC[case]
    rules = make_rules(mesh24)
    with FakeTensorMode() as fake:
        placed = [DTensor.from_local(torch.empty(shape, dtype=dt), mesh24,
                                     pl, run_check=False).requires_grad_(g)
                  for shape, pl, dt, g in args]
    counter = ProgramCounter(mesh24, placed)
    with fake, use_rules(rules), counter:
        out = step(*placed)
        memory = counter.memory(out)
    got = {k: (v["count"], v["bytes"],
               {a: e["bytes"] for a, e in v["axes"].items()})
           for k, v in counter.collectives.items()}
    assert got == want
    local = out.to_local()
    assert memory["output_size_in_bytes"] == local.numel() * 2
    if temp is not None:
        assert memory["temp_size_in_bytes"] == temp


# ------------------------------------------------------- against JAX
@pytest.fixture(scope="module")
def jax_programs():
    script = (f"SRC = {SRC!r}\nCELLS = {JAX_CELLS!r}\n" + JAX_PROGRAMS)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout)


def _forced_bytes(cfg, shape, mesh):
    """(gather, reduce) bytes a device must move for the parameters alone:
    each fsdp-sharded leaf gathered over "data" (its block over the other
    axes) and its gradient reduced to its local block; a stacked leaf
    counts one layer."""
    rules = make_rules(mesh, overrides=arch_overrides(cfg, mesh, shape))
    with FakeTensorMode():
        params = model_state_specs(cfg, with_opt=False)
    shardings = param_shardings(params, rules)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    gather = reduce = 0

    def one(path, leaf):
        nonlocal gather, reduce
        s = _leaf(shardings, path)
        axes = [a for e in s.spec for a in ((e,) if isinstance(e, str)
                                            else e or ())]
        if "data" not in axes:
            return
        n = leaf.numel() * leaf.element_size()
        if path_str(path).startswith(("layers/", "cross/")):
            n //= leaf.shape[0]
        for a in axes:
            if a != "data":
                n //= sizes[a]
        gather += n
        reduce += n // sizes["data"]

    tree_map_with_path(one, params)
    return gather, reduce


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _port_program(mesh, arch, kind, batch, seq):
    cfg = ARCHS[arch].smoke()
    shape = ShapeConfig(kind, seq, batch, kind)
    rules = make_rules(mesh, overrides=arch_overrides(cfg, mesh, shape))
    return program_cell(cfg, shape, mesh, rules, rules, {})


@pytest.mark.parametrize("arch,kind,batch,seq", JAX_CELLS)
def test_program_gathers_and_reduces_as_jax(jax_programs, mesh24, arch, kind,
                                            batch, seq):
    port = _port_program(mesh24, arch, kind, batch, seq)["collectives"]
    jax_ = jax_programs[f"{arch}|{kind}"]["collectives"]
    gather, reduce = _forced_bytes(ARCHS[arch].smoke(),
                                   ShapeConfig(kind, seq, batch, kind), mesh24)
    assert gather > 0 and reduce > 0
    # the port gathers every fsdp weight in every cell; XLA does in the
    # train cells, and in granite-moe's decode sums partial expert
    # products instead (ROADMAP Queue 3)
    programs = [("port", port)] + ([("jax", jax_)] if kind == "train" else [])
    for name, coll in programs:
        def b(k):
            return coll.get(k, {}).get("bytes", 0)
        assert b("all-gather") >= gather, (name, coll, gather)
        if kind == "train":
            assert b("all-reduce") + b("reduce-scatter") >= reduce, (
                name, coll, reduce)
    total_port = sum(c["bytes"] for c in port.values())
    total_jax = sum(c["bytes"] for c in jax_.values())
    ratio = total_port / total_jax
    assert 1 / TOTAL_RATIO <= ratio <= TOTAL_RATIO, (port, jax_)


# ---------------------------------------------- plain path, bit for bit
def _place(mesh, tree, shardings):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [
        DTensor.from_local(t.detach().clone(), mesh, s.placements,
                           run_check=False)
        for t, s in zip(leaves, tree_leaves(shardings))])


def _local(tree):
    return tree_map(lambda t: t.to_local() if isinstance(t, DTensor)
                    else t, tree)


def _extra(cfg, gen, batch):
    out = {}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = torch.randn(
            batch, cfg.vision_tokens, cfg.d_model, generator=gen).to(BF16)
    if cfg.enc_layers:
        out["frame_embeds"] = torch.randn(batch, 32, cfg.d_model,
                                          generator=gen).to(BF16)
    return out


def _bit_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(_local(b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_on_dtensors_is_bit_equal(gloo_mesh, arch):
    cfg = ARCHS[arch].smoke()
    rules = make_rules(gloo_mesh, overrides=arch_overrides(
        cfg, gloo_mesh, SHAPES["train_4k"]))
    params = init_model(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=gen,
                              dtype=torch.int32)
             for k in ("tokens", "labels")} | _extra(cfg, gen, 4)
    p_sh = param_shardings(params, rules)
    opt = adamw.init(params)
    d_opt = adamw.AdamWState(step=_place(gloo_mesh, opt.step,
                                         rules.sharding(())),
                             m=_place(gloo_mesh, opt.m, p_sh),
                             v=_place(gloo_mesh, opt.v, p_sh))
    d_params = _place(gloo_mesh, params, p_sh)
    d_batch = _place(gloo_mesh, batch, batch_shardings(cfg, rules, batch))
    step = make_train_step(cfg, adamw.AdamWConfig(), microbatches=2)
    plain = step(params, opt, batch)
    with use_rules(rules):
        placed = step(d_params, d_opt, d_batch)
    assert all(isinstance(t, DTensor) for t in tree_leaves(placed[:2]))
    assert _bit_equal(plain, placed)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decode_step_on_dtensors_is_bit_equal(gloo_mesh, arch):
    cfg = ARCHS[arch].smoke()
    rules = make_rules(gloo_mesh, overrides=arch_overrides(
        cfg, gloo_mesh, SHAPES["decode_32k"]))
    params = init_model(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (4, 16), generator=gen,
                           dtype=torch.int32)
    extra = _extra(cfg, gen, 4)
    with torch.no_grad():
        logits, caches = prefill(cfg, params, tokens, extra=extra or None,
                                 max_seq=40)
        pos = torch.tensor(16 + (cfg.vision_tokens
                                 if cfg.frontend == "vision_stub" else 0),
                           dtype=torch.int32)
        specs = {"tokens": logits.argmax(-1).to(torch.int32),
                 "caches": caches, "pos": pos}
        placed = _place(gloo_mesh, specs,
                        batch_shardings(cfg, rules, specs))
        d_params = _place(gloo_mesh, params, param_shardings(params, rules))
        plain = decode_step(cfg, params, specs["tokens"],
                            tree_map(torch.clone, caches), pos,
                            per_row=False)
        with use_rules(rules):
            ruled = decode_step(cfg, d_params, placed["tokens"],
                                placed["caches"], placed["pos"],
                                per_row=False)
    assert isinstance(ruled[0], DTensor)
    assert _bit_equal(plain, ruled)
