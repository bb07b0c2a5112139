"""Multi-pod dry-run: every (arch × shape × mesh) cell's per-device program.

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
     ``DTensor`` of a fake local shard on the fake mesh, checking that
     every local shape times its mesh factors gives the global shape,
  4. runs the step on those DTensors inside ``use_rules`` — the
     per-device program: every ``shard()`` pin redistributes, each
     weight is gathered over its fsdp axis where it is used, each
     kernel runs on its local shards (``kernels.spmd``) — under a
     :class:`ProgramCounter`; success proves that the program exists,
  5. records to JSON, under the JAX package's record keys:
     ``collectives`` — per kind (``all-gather``, ``all-reduce``,
     ``reduce-scatter``, ``all-to-all``, ``collective-permute``) the
     count and the bytes of the results on one device, as
     ``repro.launch.dryrun.collective_bytes`` sums them, and beside them
     ``axes``, the same by the mesh axis each collective spans;
     ``memory`` — ``argument_size_in_bytes`` (the local shards of every
     argument), ``output_size_in_bytes`` and ``alias_size_in_bytes``
     (what the step returns, and the part of it updated in place in an
     argument), ``temp_size_in_bytes`` (the peak of live local bytes
     above the arguments, less the new outputs); ``cost.flops`` — the
     FLOPs of the local operations on one device, replicated work
     counted on every device, as JAX's ``cost_analysis`` counts;
     ``mesh_axes`` — the mesh's axes and sizes; ``lower_s`` — seconds to
     build and place the arguments; ``compile_s`` — seconds of the step.

Everything is counted on fake tensors, not measured.  Two counts differ
from the JAX package's by construction: JAX reads its compiled HLO text,
where a collective in a loop body (the scanned unit of layers) counts
once, while the port counts every collective it runs; and XLA's own
choices (padding a dimension a mesh axis does not divide, fusing a
reduce-scatter into an all-reduce) are not DTensor's (ROADMAP Queue 3).

Usage:
    python -m repro_torch.launch.dryrun --arch internlm2-1.8b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import weakref
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


#: the JAX package's collective names, by the torch op that issues one
#: (the functional collectives DTensor's redistributions run, and
#: DTensor's own all-to-all between two shard dims)
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


def _storages(tree):
    """{storage key: (storage, bytes)} of every tensor in ``tree``, a
    DTensor counted by its local tensor."""
    from torch.distributed.tensor import DTensor

    out = {}
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = (st, st.nbytes())
    return out


def _enumerate(nested, prefix=()):
    """(coordinate, value) of every entry of a nested list."""
    if not isinstance(nested, list):
        yield prefix, nested
        return
    for i, x in enumerate(nested):
        yield from _enumerate(x, prefix + (i,))


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


class ProgramCounter:
    """The per-device program's collectives, FLOPs and live memory.

    A ``TorchDispatchMode`` under which a step runs on DTensors: it lets
    DTensor's own dispatch run first (it returns ``NotImplemented`` for
    a DTensor operation), so it sees the operations each device runs on
    its local shards — the functional collectives of every
    redistribution included.  It records:

    - per collective kind, under the JAX package's names, the count and
      the bytes of the result on one device (as
      ``repro.launch.dryrun.collective_bytes`` sums the post-SPMD HLO),
      and under ``axes`` the same split by the mesh dimension the
      collective spans;
    - the FLOPs of the local operations (``torch.utils.flop_counter``'s
      formulas): one device's share, replicated work counted on every
      device, as JAX's ``cost_analysis`` counts it;
    - the bytes of every storage made during the step and alive, by
      weak reference (each is freed when its last tensor is): the peak
      of that sum is the step's peak above its arguments (``args``).

    A plain tensor that meets a DTensor is made a replicated DTensor
    (DTensor's ``implicit_replication`` does not reach past a dispatch
    mode).  Without a ``mesh`` it counts a step on plain tensors, real
    or fake: its FLOPs and memory.
    """

    def __init__(self, mesh=None, args=()) -> None:
        from torch.utils._python_dispatch import TorchDispatchMode

        self.names = () if mesh is None else tuple(mesh.mesh_dim_names)
        self.groups = {mesh.get_group(i).group_name: name
                       for i, name in enumerate(self.names)}
        # each rank's coordinate on the mesh, read here, outside the step's
        # fake mode
        self._coords = {} if mesh is None else {
            rank: coord for coord, rank in _enumerate(mesh.mesh.tolist())}
        self.collectives: Dict[str, dict] = {}
        self.flops = 0
        self.live = self.peak = 0
        self._args = set(_storages(args))
        self._refs: Dict[int, Any] = {}
        self._quiet = 0
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()

    def __enter__(self):
        """Counts inside.  Two of DTensor's own computations are not the
        program's: the operation it runs on global-shape fake tensors to
        learn an output's shape (its sharding propagation) is not
        counted; and on a CPU mesh it runs an all-to-all between two
        shard dims as a gather of the whole dimension and a chunk of it
        (gloo has no all-to-all), which is counted as the all-to-all it
        stands for, with its result's bytes, and what the gather makes
        is not counted as live memory."""
        from torch.distributed.tensor import placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self._stack = contextlib.ExitStack()
        if hasattr(placement_types, "shard_dim_alltoall"):
            self._stack.enter_context(_patched(
                placement_types, "shard_dim_alltoall",
                self._alltoall(placement_types.shard_dim_alltoall)))
        meta = "_propagate_tensor_meta_non_cached"
        if not hasattr(ShardingPropagator, meta):
            meta = "_propagate_tensor_meta"
        self._stack.enter_context(_patched(
            ShardingPropagator, meta,
            self._quietly(getattr(ShardingPropagator, meta))))
        self._stack.enter_context(self._mode)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    def _quietly(self, run):
        def quiet(*args, **kwargs):
            self._quiet += 1
            try:
                return run(*args, **kwargs)
            finally:
                self._quiet -= 1

        return quiet

    def _alltoall(self, run):
        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            self._quiet += 1
            try:
                out = run(input, gather_dim, shard_dim, mesh, mesh_dim)
            finally:
                self._quiet -= 1
            self._collective("all-to-all", mesh.mesh_dim_names[mesh_dim], out)
            self._track(out)
            return out

        return alltoall

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils import _pytree as pytree
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            flat, spec = pytree.tree_flatten((args, kwargs))
            mesh = next(a.device_mesh for a in flat if isinstance(a, DTensor))
            plain = [isinstance(a, torch.Tensor) and not isinstance(a, DTensor)
                     and a.dim() > 0 for a in flat]
            if not any(plain):
                return NotImplemented  # DTensor desugars it to local ops
            # a tensor made in the step (positions, masks) is the same on
            # every device: it meets the DTensors as a replicated one
            flat = [DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False) if p else a
                    for a, p in zip(flat, plain)]
            args, kwargs = pytree.tree_unflatten(flat, spec)
            with self._mode:
                return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if self._quiet:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry and func.namespace == "aten":
            with self._mode:  # as FlopCounterMode: count its decomposition
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = packet.__name__.split(".")[-1]
        kind = COLLECTIVE_KINDS.get(name)
        if (kind is None and name != "wait_tensor"
                and func.namespace.startswith("_c10d_functional")):
            raise NotImplementedError(f"a collective the dry-run cannot "
                                      f"count: {func}")
        if kind is not None and func.namespace in (
                "_c10d_functional", "_c10d_functional_autograd", "_dtensor"):
            names = [a.name for a in func._schema.arguments]
            group = kwargs.get("group_name", args[names.index("group_name")]
                               if "group_name" in names[:len(args)] else None)
            self._collective(kind, self._axes(group), out)
        if packet.__name__.endswith("wait_tensor"):
            # the wait returns its input's buffer: a fake tensor makes a
            # new one, which the input's bytes stand for while it lives
            out._waited = args[0]
            self._track(out, counted=False)
        else:  # a view of an input is no new storage
            self._track(out, seen=_storages((args, kwargs)))
        return out

    def _axes(self, group) -> str:
        """The mesh axes a collective's group spans, "+"-joined in mesh
        order: one axis, or several where DTensor reduces over a
        flattened mesh."""
        if group not in self.groups:
            from torch.distributed import distributed_c10d as c10d

            ranks = c10d.get_process_group_ranks(
                c10d._resolve_process_group(group))
            where = [self._coords[r] for r in ranks]
            self.groups[group] = "+".join(
                name for i, name in enumerate(self.names)
                if len({c[i] for c in where}) > 1)
        return self.groups[group]

    def _collective(self, kind, axis, out) -> None:
        nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(out)
                     if isinstance(t, torch.Tensor))
        entry = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0, "axes": {}})
        by_axis = entry["axes"].setdefault(axis, {"count": 0, "bytes": 0})
        for e in (entry, by_axis):
            e["count"] += 1
            e["bytes"] += nbytes

    def _track(self, out, counted: bool = True, seen=()) -> None:
        for key, (st, nbytes) in _storages(out).items():
            if key in self._args or key in self._refs or key in seen:
                continue
            nbytes = nbytes if counted else 0
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=nbytes: self._free(key, n))
            self.live += nbytes
        self.peak = max(self.peak, self.live)

    def _free(self, key, nbytes) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def memory(self, outputs) -> Dict[str, int]:
        """The JAX package's memory keys for a step that returned
        ``outputs``: ``output_size_in_bytes`` — the local bytes of what
        it returns; ``alias_size_in_bytes`` — those of them that are an
        argument's (updated in place, as JAX's donated buffers);
        ``temp_size_in_bytes`` — the peak of live local bytes above the
        arguments, less the outputs that are not arguments'."""
        stores = _storages(outputs)
        out = sum(n for _, n in stores.values())
        alias = sum(n for k, (_, n) in stores.items() if k in self._args)
        return {"output_size_in_bytes": int(out),
                "alias_size_in_bytes": int(alias),
                "temp_size_in_bytes": int(self.peak - (out - alias))}


def place(tree, shardings) -> Tuple[Any, int]:
    """Each leaf of ``tree`` as a DTensor of a fake local shard, made in
    the active fake mode; returns (the DTensors, the per-device bytes
    of the local shards).  Raises where a local shape times its mesh
    factors is not the global shape."""
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor

    from ..tree import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    placed, nbytes = [], 0
    for leaf, s in zip(leaves, tree_leaves(shardings)):
        meta = torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta")
        local_shape = distribute_tensor(meta, s.mesh,
                                        s.placements).to_local().shape
        factors = [1] * meta.dim()
        for size, p in zip(s.mesh.shape, s.placements):
            if isinstance(p, Shard):
                factors[p.dim] *= size
        if [n * f for n, f in zip(local_shape, factors)] != list(meta.shape):
            raise ValueError(
                f"local shape {tuple(local_shape)} × mesh factors {factors} "
                f"is not the global shape {tuple(meta.shape)} under spec "
                f"{s.spec}"
            )
        local = torch.empty(tuple(local_shape), dtype=leaf.dtype,
                            device=leaf.device)
        placed.append(DTensor.from_local(local, s.mesh, s.placements,
                                         run_check=False))
        nbytes += local.numel() * meta.element_size()
    return tree_unflatten(treedef, placed), nbytes


def program_cell(cfg, shape, mesh, rules: Rules, p_rules: Rules,
                 v: Dict[str, Any]) -> Dict[str, Any]:
    """Run one cell's step as the per-device program: the parameters,
    the moments and the batch placed as DTensors of fake local shards,
    the step run on them inside ``use_rules(rules)`` under a
    :class:`ProgramCounter`.  Returns the record's measured keys."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..dist.sharding import use_rules
    from ..models import decode_step, prefill
    from ..optim import adamw
    from ..train.train_step import make_train_step
    from .specs import input_specs, model_state_specs

    t0 = time.time()
    with FakeTensorMode() as fake:
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            params, opt = model_state_specs(cfg)
        else:
            params, opt = model_state_specs(cfg, with_opt=False), None
        params, arg_bytes = place(params, param_shardings(params, p_rules))
        if opt is not None:
            m_shard = param_shardings(params, rules)
            step, b0 = place(opt.step, rules.sharding(()))
            m, b1 = place(opt.m, m_shard)
            mv, b2 = place(opt.v, m_shard)
            opt = adamw.AdamWState(step=step, m=m, v=mv)
            arg_bytes += b0 + b1 + b2
        batch, b3 = place(specs, batch_shardings(cfg, rules, specs))
        arg_bytes += b3
    t_place = time.time() - t0

    counter = ProgramCounter(mesh, (params, opt, batch))
    with fake, use_rules(rules), counter:
        if shape.kind == "train":
            step_fn = make_train_step(
                cfg, adamw.AdamWConfig(),
                microbatches=v.get("microbatches", 1),
                remat=v.get("remat", True),
                loss_chunk=v.get("loss_chunk"),
            )
            out = step_fn(params, opt, batch)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    extra = {k: x for k, x in batch.items() if k != "tokens"}
                    out = prefill(cfg, params, batch["tokens"],
                                  extra=extra or None, max_seq=shape.seq_len)
                else:  # the batch is one dispatch group, as in JAX
                    out = decode_step(cfg, params, batch["tokens"],
                                      batch["caches"], batch["pos"],
                                      per_row=False)
        memory = counter.memory(out)
    del out
    return {
        "lower_s": round(t_place, 2),
        "compile_s": round(time.time() - t0 - t_place, 2),
        "cost": {"flops": float(counter.flops)},
        "memory": {"argument_size_in_bytes": int(arg_bytes)} | memory,
        "collectives": counter.collectives,
        "mesh_axes": [[n, int(s)] for n, s in zip(mesh.mesh_dim_names,
                                                   mesh.shape)],
    }


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               variant: str = "baseline") -> Dict[str, Any]:
    """Place and run one (arch × shape × mesh) cell's per-device program;
    returns its record (``skipped`` where the shape does not apply)."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    if shape_name not in cfg.applicable_shapes:
        return {"skipped": True, "reason": "shape not applicable"}
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules, p_rules = cell_rules(cfg, shape, mesh, variant)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod),
        "kind": shape.kind,
        "variant": variant,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    } | program_cell(cfg, shape, mesh, rules, p_rules, VARIANTS[variant])


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
            coll = sum(c["bytes"] for c in record["collectives"].values())
            print(f"[ ok ] {tag}: place {record['lower_s']:.1f}s "
                  f"step {record['compile_s']:.1f}s "
                  f"flops/dev={record['cost']['flops']:.3e} "
                  f"collective B/dev={coll:.3e} temp B/dev="
                  f"{record['memory']['temp_size_in_bytes']:.3e}")
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
