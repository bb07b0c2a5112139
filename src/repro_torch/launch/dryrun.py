"""Multi-pod dry-run: place and trace every (arch × shape × mesh) cell.

The port's counterpart of ``repro.launch.dryrun``, on one host and no
chip.  The production meshes are ``DeviceMesh`` es over torch's fake
process group (:mod:`repro_torch.launch.mesh`), which :func:`main` sets up
itself:

    single-pod: (16, 16)      ("data", "model")        = 256 chips
    multi-pod:  (2, 16, 16)   ("pod", "data", "model") = 512 chips

Per cell the dry-run:
  1. builds fake-tensor stand-ins (no allocation) for params, optimizer
     state and batch (:mod:`repro_torch.launch.specs`),
  2. resolves arch/shape-aware sharding rules
     (:mod:`repro_torch.dist.presets`),
  3. places every parameter leaf, both moments and every batch leaf as a
     ``DTensor`` (of a meta twin) on the fake mesh and checks that every
     local shape times its mesh factors gives the global shape — success
     proves the distribution config is coherent,
  4. runs the step once on the fake global tensors inside ``use_rules``
     (every ``shard()`` pin of the model resolves its axes) and under
     ``FlopCounterMode``,
  5. records to JSON, under the JAX package's record keys:
     ``memory.argument_size_in_bytes`` — the per-device bytes of the
     local shards of every argument; ``cost.flops`` — the counted FLOPs
     divided by the chips (per device, as JAX's ``cost_analysis`` is);
     ``lower_s`` — seconds to build the specs and place them;
     ``compile_s`` — seconds of the traced step.

What the record cannot have: ``memory.temp_size_in_bytes`` and the
per-collective bytes come from the compiled per-device program in JAX;
the port has no per-device execution to read them from, so both are
``null`` here.  The numbers are counted on fake tensors, not measured.

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import ARCHS, SHAPES
from ..dist.presets import arch_overrides, batch_shardings
from ..dist.sharding import Rules, make_rules, param_shardings
from ..tree import tree_leaves
from .mesh import destroy_mesh_group, make_production_mesh

#: §Perf variants — the JAX package's hypotheses, under the same names
VARIANTS = {
    "baseline": {},
    # qwen-train: never materialize [B,S,V] f32 logits
    "chunked_loss": {"loss_chunk": 512},
    # qwen-train: save matmul outputs in remat (cuts the 4/3 recompute tax)
    "dots": {"remat": "dots"},
    "chunked+dots": {"loss_chunk": 512, "remat": "dots"},
    # qwen-train: n-way microbatch accumulation — activation residency
    # divides by n
    "micro8": {"microbatches": 8, "loss_chunk": 512},
    "micro16": {"microbatches": 16, "loss_chunk": 512},
    "micro32": {"microbatches": 32, "loss_chunk": 512},
    # zamba2-train: ZeRO-1 — params replicated (no per-layer fsdp gathers),
    # optimizer state still sharded over data
    "zero1": {"zero1": True},
    # decode cells: serve-mode sharding — weights TP-resident (no fsdp
    # all-gathers per step), KV cache sequence-sharded over the model axis,
    # MoE expert-internal dim over data (token-sized collectives only)
    "serve_v2": {"serve_v2": True},
    # vocab-sharded embedding tables force gather and scatter collectives —
    # replicating the table trades ≤1 GiB HBM for the whole chain
    "serve_v3": {"serve_v2": True, "repembed": True},
    "zero1+repembed": {"zero1": True, "repembed": True},
    "repembed": {"repembed": True},
}


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def cell_rules(cfg, shape, mesh, variant: str) -> Tuple[Rules, Rules]:
    """(rules, param_rules) of one cell, as the JAX package's
    ``build_cell`` resolves them: ``rules`` place the batch, the
    optimizer moments and every ``shard()`` pin; ``param_rules`` the
    parameters (ZeRO-1 drops their fsdp axis)."""
    v = VARIANTS[variant]
    overrides = arch_overrides(cfg, mesh, shape)
    if v.get("serve_v2"):
        overrides["fsdp"] = None
        overrides["kv_seq"] = "model"
        if cfg.moe is not None and overrides.get("expert", "x") is not None:
            # experts shard over model × data: the one-group decode
            # dispatch has no batch axis in the expert product
            overrides["expert_mlp"] = "data"
    if v.get("repembed"):
        overrides["vocab"] = None
    rules = make_rules(mesh, overrides=overrides)
    if shape.kind == "train" and v.get("zero1"):
        return rules, make_rules(mesh, overrides=overrides | {"fsdp": None})
    return rules, rules


def _placed_bytes(tree, shardings) -> int:
    """Place each leaf of ``tree`` as a DTensor of a meta twin under its
    sharding; returns the per-device bytes of the local shards.  Raises
    where a local shape times its mesh factors is not the global
    shape."""
    from torch.distributed.tensor import Shard, distribute_tensor

    nbytes = 0
    for leaf, s in zip(tree_leaves(tree), tree_leaves(shardings)):
        meta = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")
        d = distribute_tensor(meta, s.mesh, s.placements)
        local = d.to_local()
        factors = [1] * meta.dim()
        for size, p in zip(s.mesh.shape, s.placements):
            if isinstance(p, Shard):
                factors[p.dim] *= size
        if [n * f for n, f in zip(local.shape, factors)] != list(meta.shape):
            raise ValueError(
                f"local shape {tuple(local.shape)} × mesh factors {factors} "
                f"is not the global shape {tuple(meta.shape)} under spec "
                f"{s.spec}"
            )
        nbytes += local.numel() * meta.element_size()
    return nbytes


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               variant: str = "baseline") -> Dict[str, Any]:
    """Place and trace one (arch × shape × mesh) cell; returns its record
    (``skipped`` where the shape does not apply)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..dist.sharding import use_rules
    from ..models import decode_step, prefill
    from ..optim import adamw
    from ..train.train_step import make_train_step
    from .specs import input_specs, model_state_specs

    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if shape_name not in cfg.applicable_shapes:
        return {"skipped": True, "reason": "shape not applicable"}
    v = VARIANTS[variant]
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules, p_rules = cell_rules(cfg, shape, mesh, variant)
    with FakeTensorMode():
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            params, opt = model_state_specs(cfg)
        else:
            params, opt = model_state_specs(cfg, with_opt=False), None
    arg_bytes = _placed_bytes(params, param_shardings(params, p_rules))
    if opt is not None:
        m_shard = param_shardings(params, rules)
        arg_bytes += _placed_bytes(opt.step, rules.sharding(()))
        for moments in (opt.m, opt.v):
            arg_bytes += _placed_bytes(moments, m_shard)
    arg_bytes += _placed_bytes(specs, batch_shardings(cfg, rules, specs))
    t_place = time.time() - t0

    flops = FlopCounterMode(display=False)
    with specs["tokens"].fake_mode, use_rules(rules), flops:
        if shape.kind == "train":
            step_fn = make_train_step(
                cfg, adamw.AdamWConfig(),
                microbatches=v.get("microbatches", 1),
                remat=v.get("remat", True),
                loss_chunk=v.get("loss_chunk"),
            )
            step_fn(params, opt, specs)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    extra = {k: x for k, x in specs.items() if k != "tokens"}
                    prefill(cfg, params, specs["tokens"],
                            extra=extra or None, max_seq=shape.seq_len)
                else:  # the batch is one dispatch group, as in JAX
                    decode_step(cfg, params, specs["tokens"],
                                specs["caches"], specs["pos"],
                                per_row=False)
    t_trace = time.time() - t0 - t_place
    chips = mesh.size()
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": shape.kind,
        "variant": variant,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "lower_s": round(t_place, 2),
        "compile_s": round(t_trace, 2),
        "cost": {"flops": float(flops.get_total_flops()) / chips},
        "memory": {"argument_size_in_bytes": int(arg_bytes),
                   "temp_size_in_bytes": None},
        "collectives": None,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str,
             variant: str = "baseline") -> Dict[str, Any]:
    tag = f"{arch}__{shape_name}__{mesh_name(multi_pod)}"
    if variant != "baseline":
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path):
        with open(path) as f:
            prev = json.load(f)
        if "error" not in prev:
            print(f"[skip] {tag} (cached)")
            return prev
    try:
        record = build_cell(arch, shape_name, multi_pod=multi_pod,
                            variant=variant)
        if record.get("skipped"):
            record |= {"arch": arch, "shape": shape_name}
            print(f"[n/a ] {tag}: {record['reason']}")
        else:
            print(f"[ ok ] {tag}: place {record['lower_s']:.1f}s "
                  f"trace {record['compile_s']:.1f}s "
                  f"flops/dev={record['cost']['flops']:.3e}")
    except Exception as e:  # record failures — they are bugs to fix
        record = {
            "arch": arch,
            "shape": shape_name,
            "mesh": mesh_name(multi_pod),
            "error": f"{type(e).__name__}: {e}"[:2000],
        }
        print(f"[FAIL] {tag}: {record['error'][:200]}")
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    ok = fail = skipped = 0
    try:
        for a, s, mp in cells:
            rec = run_cell(a, s, multi_pod=mp, out_dir=args.out,
                           variant=args.variant)
            if rec.get("skipped"):
                skipped += 1
            elif "error" in rec:
                fail += 1
            else:
                ok += 1
    finally:
        destroy_mesh_group()
    print(f"\ndry-run: {ok} ok, {fail} failed, {skipped} n/a")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
