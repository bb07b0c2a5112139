"""SPMD sharding rules: logical axes, activation pins, param specs.

The model code names *logical* axes ("batch", "heads", "mlp", …); a
:class:`Rules` object maps them onto the *mesh* axes of the current
topology ("data", "model", optionally "pod") of a
``torch.distributed.device_mesh.DeviceMesh``.  Three consumers:

* activations — ``shard(x, ("batch", "seq", "embed"))`` inside the model
  returns ``x`` itself until a :func:`use_rules` context is active.
  Inside one it resolves every axis (an unknown name raises) and
  redistributes a ``DTensor`` to the resolved placements; a plain tensor
  is returned unchanged, since one card holds it whole (no launch, copy
  or synchronisation).
* parameters — regex rules over the param *path* ("layers/b0/attn/wq")
  resolve each weight to a spec; leading scan/stack dims that the rule
  does not mention are padded with ``None`` (replicated), so the same
  rule covers a single block and its stacked unit.
* mesh hygiene — each mesh axis is used at most once per spec: when two
  logical axes resolve to the same mesh axis the *first* one wins and the
  second gets ``None``.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), a mesh-axis name, or a tuple of names — entry for entry
``tuple(jax.sharding.PartitionSpec)`` of the JAX package.  A
:class:`NamedSharding` pairs a spec with its mesh and the DTensor
placements it stands for (:meth:`Rules.placements`).
"""

from __future__ import annotations

import contextlib
import re
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from ..tree import tree_map, tree_map_with_path

PyTree = Any
#: a logical axis resolves to one mesh axis, several (e.g. batch over
#: ("pod", "data")), or None (replicated)
MeshAxes = Union[None, str, Tuple[str, ...]]
#: one entry per tensor dimension, as ``tuple(PartitionSpec)``
Spec = Tuple[MeshAxes, ...]

#: default logical-axis → mesh-axis map.  Axes absent from the active mesh
#: are dropped at resolve time, so ("pod", "data") degrades to "data" on a
#: single-pod mesh.
DEFAULT_AXIS_MAP: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",  # dedup nulls this whenever batch already took "data"
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "expert": "model",
    "expert_mlp": "model",
    "kv_seq": None,  # serve presets may map the KV seq axis onto "model"
    # parameters
    "fsdp": "data",  # the d_model axis of every weight (ZeRO-3 style)
}

#: ordered (path-regex, logical axes) param rules — first match wins.
#: Paths are "/"-joined tree key paths, e.g. "layers/b0/attn/wq".
DEFAULT_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed/tokens$", ("vocab", "fsdp")),
    (r"lm_head$", ("fsdp", "vocab")),
    # GQA attention
    (r"w[qkv]$", ("fsdp", "heads")),
    (r"b[qkv]$", ("heads",)),
    (r"wo$", ("heads", "fsdp")),
    # MLA: latent ranks replicated, head-expanded dims model-parallel
    (r"wq_a$", ("fsdp", None)),
    (r"wq_b$", (None, "heads")),
    (r"wkv_a$", ("fsdp", None)),
    (r"wkv_b$", (None, "heads")),
    # MoE (before the dense-MLP rules: "moe/gate" must not match "gate$")
    (r"router$", ("fsdp", "expert")),
    (r"moe/(gate|up)$", ("expert", "fsdp", "expert_mlp")),
    (r"moe/down$", ("expert", "expert_mlp", "fsdp")),
    # dense / shared-expert MLP
    (r"(gate|up)$", ("fsdp", "mlp")),
    (r"down$", ("mlp", "fsdp")),
    # Mamba-2
    (r"w_[zx]$", ("fsdp", "mlp")),
    (r"w_(B|C|dt)$", ("fsdp", None)),
    (r"out_proj$", ("mlp", "fsdp")),
    # adapters / modality projections
    (r"(in_adapter|out_adapter|vision_proj|audio_proj)$", ("fsdp", None)),
    # norms, biases, conv tails, A_log/D … fall through to replicated
)


@dataclass(frozen=True)
class NamedSharding:
    """A layout on ``mesh``: the spec and its DTensor placements, one
    ``Shard(dim)`` or ``Replicate()`` per mesh dimension (the
    counterpart of ``jax.sharding.NamedSharding``)."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    spec: Spec
    placements: Tuple[Any, ...]


def _parts(entry: MeshAxes) -> Tuple[str, ...]:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _entry(parts: Sequence[str]) -> MeshAxes:
    if not parts:
        return None
    return parts[0] if len(parts) == 1 else tuple(parts)


@dataclass(frozen=True)
class Rules:
    """Resolved sharding rules for one mesh: axis map + param-path rules.
    Only the mesh's ``mesh_dim_names`` and ``shape`` are read."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    axis_map: Dict[str, MeshAxes]
    param_rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...]

    # ------------------------------------------------------------ resolve
    def resolve(self, logical: Optional[str]) -> MeshAxes:
        """Logical axis → mesh axes (unknown names are an error: a typo in
        a shard() call should fail loudly, not silently replicate)."""
        if logical is None:
            return None
        if logical not in self.axis_map:
            raise KeyError(
                f"unknown logical axis {logical!r}; known: "
                f"{sorted(self.axis_map)}"
            )
        return self.axis_map[logical]

    def entries(self, axes: Sequence[Optional[str]]) -> Spec:
        """Per-dimension spec entries with mesh-axis dedup."""
        present = set(self.mesh.mesh_dim_names)
        used: set = set()
        out = []
        for ax in axes:
            parts = tuple(p for p in _parts(self.resolve(ax))
                          if p in present and p not in used)
            used.update(parts)
            out.append(_entry(parts))
        return tuple(out)

    def fit(self, entries: Sequence[MeshAxes], shape: Sequence[int]) -> Spec:
        """Drop mesh axes that do not divide the dim they would shard.

        Argument shardings must divide dims exactly (in-graph constraints
        pad, arguments don't) — e.g. a 49155-row vocab or an 8-head KV
        cache cannot split 16 ways; those dims degrade to replicated.
        """
        sizes = dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))
        out = []
        for dim, e in zip(shape, tuple(entries)):
            keep, total = [], 1
            for p in _parts(e):
                if dim % (total * sizes[p]) == 0:
                    keep.append(p)
                    total *= sizes[p]
            out.append(_entry(keep))
        return tuple(out)

    def placements(self, entries: Sequence[MeshAxes]) -> Tuple[Any, ...]:
        """One DTensor placement per mesh dimension: ``Shard(i)`` where
        entry ``i`` names that mesh axis, else ``Replicate()``.

        An entry naming several mesh axes shards its dimension over each
        of them.  DTensor splits such a dimension in mesh-dimension order
        (the first mesh dimension major), while a spec splits it in the
        entry's order; the two agree only when the entry lists its axes
        in mesh order, so an entry out of that order raises instead of
        placing the blocks elsewhere than the spec says."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        out: list = [Replicate() for _ in names]
        for i, e in enumerate(entries):
            parts = _parts(e)
            order = [names.index(p) for p in parts]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {e!r} lists mesh axes out of the mesh's "
                    f"order {tuple(names)}: DTensor would split dim {i} "
                    "in another order than the spec"
                )
            for j in order:
                if out[j] != Replicate():
                    raise ValueError(
                        f"mesh axis {names[j]!r} shards two dims of "
                        f"{tuple(entries)!r}"
                    )
                out[j] = Shard(i)
        return tuple(out)

    def _named(self, spec: Spec) -> NamedSharding:
        return NamedSharding(self.mesh, spec, self.placements(spec))

    def sharding(self, axes: Sequence[Optional[str]]) -> NamedSharding:
        return self._named(self.entries(axes))

    def fitted_sharding(
        self, axes: Sequence[Optional[str]], shape: Sequence[int]
    ) -> NamedSharding:
        return self._named(self.fit(self.entries(axes), shape))

    # ------------------------------------------------------------- params
    def spec_for_path(self, path: str, ndim: int) -> Spec:
        for pattern, axes in self.param_rules:
            if re.search(pattern, path):
                entries = self.entries(axes)
                if len(entries) < ndim:  # leading scan/stack dims
                    entries = (None,) * (ndim - len(entries)) + entries
                elif len(entries) > ndim:
                    entries = entries[-ndim:] if ndim else ()
                return entries
        return ()  # unknown → replicated


def make_rules(
    mesh,
    *,
    overrides: Optional[Dict[str, MeshAxes]] = None,
    param_rules: Optional[Sequence[Tuple[str, Tuple[Optional[str], ...]]]] = None,
) -> Rules:
    """Build :class:`Rules` for ``mesh``; ``overrides`` remap logical axes
    (e.g. ``{"fsdp": None}`` for ZeRO-1, ``{"kv_seq": "model"}`` for
    sequence-sharded serving caches)."""
    axis_map = dict(DEFAULT_AXIS_MAP)
    if overrides:
        axis_map.update(overrides)
    return Rules(
        mesh=mesh,
        axis_map=axis_map,
        param_rules=tuple(param_rules or DEFAULT_PARAM_RULES),
    )


# ------------------------------------------------------------- path helpers
def path_str(path: Sequence[Any]) -> str:
    """Tree key path (from :func:`repro_torch.tree.tree_map_with_path`) →
    "layers/b0/attn/wq"-style string, as the JAX package joins its key
    paths."""
    return "/".join(str(k) for k in path)


def param_spec_for_path(path: str, rules: Rules, ndim: int) -> Spec:
    """Spec of one parameter identified by its tree path."""
    return rules.spec_for_path(path, ndim)


def param_shardings(params: PyTree, rules: Rules) -> PyTree:
    """:class:`NamedSharding` tree matching ``params`` (tensors, fake or
    meta tensors).  Shapes are known here, so non-divisible dims degrade
    to replicated (see :meth:`Rules.fit`)."""

    def one(path, leaf):
        spec = rules.spec_for_path(path_str(path), leaf.dim())
        return rules._named(rules.fit(spec, tuple(leaf.shape)))

    return tree_map_with_path(one, params)


# -------------------------------------------------------- activation hook
_ACTIVE_RULES: ContextVar[Optional[Rules]] = ContextVar(
    "repro_torch_dist_active_rules", default=None
)


def current_rules() -> Optional[Rules]:
    return _ACTIVE_RULES.get()


@contextlib.contextmanager
def use_rules(rules: Rules):
    """Activate ``rules`` for :func:`shard` calls made in this context.
    A plain tensor that the step makes from nothing (positions, masks)
    meets DTensors here as a replicated one: each device makes the same
    (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _ACTIVE_RULES.set(rules)
    try:
        with implicit_replication():
            yield rules
    finally:
        _ACTIVE_RULES.reset(token)


def is_dtensor(x) -> bool:
    """True for a ``DTensor``: the step runs as a per-device program."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Activation sharding pin; ``x`` itself when no rules are active.

    ``axes`` names one logical axis (or None) per tensor dimension.
    Under :func:`use_rules` every axis is resolved (an unknown name
    raises ``KeyError``); a ``DTensor`` is redistributed to the resolved
    placements, and a plain tensor, which one card holds whole, is
    returned unchanged.  As the JAX package's in-graph constraints pad
    where arguments must divide, a pin may split a dimension unevenly
    (DTensor's ``torch.chunk`` blocks: the first device holds the
    largest).
    """
    rules = _ACTIVE_RULES.get()
    if rules is None:
        return x
    entries = rules.entries(axes)  # resolves every axis: a typo raises
    if is_dtensor(x):
        return _pin(x, rules.mesh, rules.placements(entries))
    return x


def _pin(x, mesh, placements):
    """``x.redistribute(mesh, placements)``, and where ``x`` holds a sum
    pending over a mesh dim (``Partial``), its gradient whole on that dim
    (each device's addend takes the whole gradient: the all-reduce's
    mirror is no collective, the reduce-scatter's an all-gather, as XLA
    and Megatron place them), not a pending sum for a later operation
    to resolve."""
    from torch.distributed.tensor import Partial

    if not any(isinstance(p, Partial) for p in x.placements):
        return x.redistribute(mesh, placements)
    return _Reduce.apply(x, mesh, tuple(placements))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, placements):
        from torch.distributed.tensor import Partial, Replicate

        ctx.mesh = mesh
        ctx.grad = tuple(Replicate() if isinstance(p, Partial) else p
                         for p in x.placements)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.grad), None, None


def split_heads(x: torch.Tensor, heads: int, axes: Sequence[Optional[str]]
                ) -> torch.Tensor:
    """[B, S, heads·hd] → [B, heads, S, hd], pinned at ``axes`` (one
    logical axis per output dimension) fitted to the head count.

    A DTensor is first redistributed so that its last dimension is split
    over exactly the mesh axes the fitted spec gives the heads — a whole
    number of heads a device — which is the one layout whose view into
    heads DTensor can take; a head count that a mesh axis does not
    divide is gathered over that axis (JAX pads it instead: ROADMAP
    Queue 3).  A plain tensor is only reshaped."""
    b, s, width = x.shape
    hd = width // heads
    rules = _ACTIVE_RULES.get()
    if rules is None or not is_dtensor(x):
        return shard(x.reshape(b, s, heads, hd).transpose(1, 2), axes)
    spec = rules.fit(rules.entries(axes), (b, heads, s, hd))
    x = x.redistribute(rules.mesh,
                       rules.placements((spec[0], spec[2], spec[1])))
    return x.reshape(b, s, heads, hd).transpose(1, 2)


def merge_heads(x: torch.Tensor, axes: Sequence[Optional[str]]
                ) -> torch.Tensor:
    """[B, heads, S, hd] → [B, S, heads·hd], the inverse of
    :func:`split_heads` for the same ``axes``.  A DTensor's result is
    pinned where the fitted heads split leaves the flat dimension, so
    that its gradient reaches the view in a layout DTensor can split
    back into heads."""
    b, heads, s, hd = x.shape
    y = x.transpose(1, 2).reshape(b, s, heads * hd)
    rules = _ACTIVE_RULES.get()
    if rules is not None and is_dtensor(y):
        spec = rules.fit(rules.entries(axes), (b, heads, s, hd))
        y = y.redistribute(rules.mesh,
                           rules.placements((spec[0], spec[2], spec[1])))
    return y


def gather_fsdp(tree: PyTree) -> PyTree:
    """Every DTensor leaf of ``tree`` gathered over the mesh axes of the
    logical axis "fsdp" (JAX's ZeRO-3 meaning: a weight is all-gathered
    where it is used, and its gradient reduce-scattered back); other
    placements stay.  A plain leaf, or no active rules, is returned
    as it is."""
    rules = _ACTIVE_RULES.get()
    if rules is None:
        return tree
    from torch.distributed.tensor import Replicate

    names = list(rules.mesh.mesh_dim_names)
    gathered = [names.index(a) for a in _parts(rules.resolve("fsdp"))
                if a in names]

    def one(x):
        if not is_dtensor(x) or all(x.placements[i] == Replicate()
                                  for i in gathered):
            return x
        placements = list(x.placements)
        for i in gathered:
            placements[i] = Replicate()
        return x.redistribute(x.device_mesh, placements)

    return tree_map(one, tree)


def split_devices(x: torch.Tensor, dim: int) -> int:
    """How many devices dimension ``dim`` of ``x`` is split over: 1 for
    a plain tensor."""
    if not is_dtensor(x):
        return 1
    from torch.distributed.tensor import Shard

    dim = dim % x.dim()
    n = 1
    for i, p in enumerate(x.placements):
        if p == Shard(dim):
            n *= x.device_mesh.size(i)
    return n


def local_block(mesh, placements, dim: int, n: int) -> Tuple[int, int]:
    """(first index, length) of this device's block of dimension ``dim``
    (global length ``n``) under ``placements``: the mesh dims that split
    it, the first major, in even blocks."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    idx = 0
    for i, p in enumerate(placements):
        if p == Shard(dim):
            idx = idx * mesh.size(i) + coord[i]
            n //= mesh.size(i)
    return idx * n, n


def on_shards(fn, inputs: Sequence, placements: Sequence, mesh,
              out_placements: Sequence, out_shapes: Sequence):
    """``fn`` over the local shards of ``inputs`` (DTensors, each first
    redistributed to its entry of ``placements``; anything else is passed
    as it is); returns one DTensor per output, of ``out_placements`` and
    the global ``out_shapes`` (a dimension may split unevenly, as
    ``torch.chunk`` splits it).  Differentiable both ways: an input whole
    on a mesh dim that splits the computation (another input or an
    output is not whole there) gets its gradient as a pending sum
    (``Partial``) over that dim, since each device saw only its part."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    split = {i for pl in (*placements, *out_placements)
             for i, p in enumerate(pl) if p != Replicate()}
    local = []
    for x, p in zip(inputs, placements):
        if isinstance(x, DTensor):
            p = tuple(p)
            grad = tuple(Partial() if i in split and q == Replicate() else q
                         for i, q in enumerate(p))
            if tuple(x.placements) != p:
                x = x.redistribute(mesh, p)
            x = x.to_local(grad_placements=grad)
        local.append(x)
    outs = fn(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else tuple(outs)
    wrapped = []
    for o, p, shape in zip(outs, out_placements, out_shapes):
        shape = torch.Size(shape)
        wrapped.append(DTensor.from_local(
            o.contiguous(), mesh, tuple(p), run_check=False, shape=shape,
            stride=_contiguous(shape)))
    return wrapped[0] if single else tuple(wrapped)


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def by_roles(fn, inputs: Sequence, roles: Sequence[Dict[str, int]],
             out_roles: Sequence[Dict[str, int]], out_shapes: Sequence,
             lead: int = 0):
    """``fn`` over local shards, for DTensor ``inputs`` whose dimensions
    play named roles (``roles[i]``: role → dim of input i, e.g.
    ``{"batch": 0, "heads": 1}``) in a computation independent along
    each role.  Each mesh dimension keeps the split ``inputs[lead]`` has
    along one of its roles; every input is split along the same role
    there (whole where it has no such dim), and every other split is
    gathered.  Outputs: ``out_roles`` and global ``out_shapes``."""
    from torch.distributed.tensor import Replicate, Shard

    ref = inputs[lead]
    mesh = ref.device_mesh
    by_dim = {d: r for r, d in roles[lead].items()}
    split = [by_dim.get(p.dim) if isinstance(p, Shard) else None
             for p in ref.placements]

    def pl(role_dims):
        return [Shard(role_dims[r]) if r in role_dims else Replicate()
                for r in split]

    return on_shards(fn, inputs, [pl(r) for r in roles], mesh,
                     [pl(r) for r in out_roles], out_shapes)
