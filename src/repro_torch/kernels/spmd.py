"""The kernels on DTensors: each runs on every device's local shards.

A kernel computes independent rows — attention per (batch row, head),
an expert product per (expert, capacity row), the SSD scan per (batch
row, head) — so a step on DTensors calls it on each device's shards,
as the JAX package's SPMD program runs its jnp twins per device.  Each
function here redistributes its inputs to the one layout its kernel
can take locally (a dimension the kernel reduces over is gathered;
``Partial`` is summed), calls the ``kernels.ops`` dispatcher on the
local tensors (the plain version on CPU tensors, the kernel on CUDA
ones) and wraps the result as a DTensor of the global shape.  The
redistributions are differentiable, so the gradients take the mirror
collectives.

Where a grouped-query K/V keeps its heads whole on a device (a head
count the mesh axis does not divide) while q's heads are split, each
device attends with the K/V heads of its own q heads.  Decode attention
over a cache whose sequence is split across devices combines the
devices' partial softmaxes: an all-reduce of the maximum and of the
sum of each row's weights, and of the weighted values (as XLA
partitions the reductions of the reference's softmax).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..dist.sharding import by_roles, local_block, on_shards
from . import ops
from .ref import NEG_INF, repeat_kv


def _placements():
    from torch.distributed.tensor import Partial, Replicate, Shard

    return Partial, Replicate, Shard


def _kept(x, dims) -> list:
    """x's placements with every one that is not a Shard of ``dims``
    replaced by Replicate (a reduced dim gathered, a Partial summed)."""
    _, Replicate, Shard = _placements()
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]


def _heads_offset(mesh, q_pl, h: int) -> Optional[int]:
    """The first of this device's q heads, where q's heads are split
    (None where they are whole)."""
    _, _, Shard = _placements()
    if Shard(1) not in q_pl:
        return None
    return local_block(mesh, q_pl, 1, h)[0]


def _kv_heads(q_pl, k, kv_dims_pl) -> list:
    """K/V placements beside q's: the batch split as q's; the heads
    split where q's and K's both are, whole elsewhere."""
    _, Replicate, Shard = _placements()
    out = []
    for i, (qp, extra) in enumerate(zip(q_pl, kv_dims_pl)):
        if extra is not None:
            out.append(extra)
        elif qp == Shard(0):
            out.append(qp)
        elif qp == Shard(1) and k.placements[i] == Shard(1):
            out.append(qp)
        else:
            out.append(Replicate())
    return out


def _select_kv(h_total: int, heads_loc: int, offset: Optional[int],
               kv_loc: int, kv_split: bool):
    """The local K/V heads that serve this device's q heads: all of them
    where K's heads are split with q's (or q's are whole), else the
    slice [first q head // G, last // G]."""
    if offset is None or kv_split:
        return None
    g = h_total // kv_loc
    lo, hi = offset // g, (offset + heads_loc - 1) // g + 1
    if heads_loc % (hi - lo):
        raise ValueError(
            f"{heads_loc} q heads a device over {hi - lo} K/V heads: the "
            "q heads of a device must share their K/V heads evenly")
    return slice(lo, hi)


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    chunk=512):
    """K3 on DTensors: q [B, H, Sq, hd], k/v [B, KV, Sk, *], split over
    the batch and the heads only."""
    _, _, Shard = _placements()
    mesh = q.device_mesh
    q_pl = _kept(q, (0, 1))
    kv_pl = _kv_heads(q_pl, k, [None] * mesh.ndim)
    h = q.shape[1]
    heads_loc = local_block(mesh, q_pl, 1, h)[1]
    sel = _select_kv(h, heads_loc, _heads_offset(mesh, q_pl, h), k.shape[1],
                     any(p == Shard(1) for p in kv_pl))

    def local(ql, kl, vl):
        if sel is not None:
            kl, vl = kl[:, sel], vl[:, sel]
        return ops.flash_attention(ql, kl, vl, causal=causal, window=window,
                                   q_offset=q_offset, chunk=chunk)

    shape = tuple(q.shape[:3]) + (v.shape[-1],)
    return on_shards(local, (q, k, v), (q_pl, kv_pl, kv_pl), mesh, (q_pl,),
                     (shape,))


def _decode_layout(q, k, cur_pos, seq_dims):
    """Placements of a one-token attention over a cache [B, KV, S, *]:
    q's batch and heads split (heads whole on ``seq_dims``), the cache
    beside them (split over its sequence on ``seq_dims``), ``cur_pos``
    as q's batch; the K/V head picker of :func:`_select_kv`, and
    ``cur_pos`` as a DTensor."""
    _, Replicate, Shard = _placements()
    from torch.distributed.tensor import DTensor

    mesh = q.device_mesh
    q_pl = [Replicate() if i in seq_dims else p
            for i, p in enumerate(_kept(q, (0, 1)))]
    kv_pl = _kv_heads(q_pl, k, [Shard(2) if i in seq_dims else None
                                for i in range(mesh.ndim)])
    pos_pl = [p if p == Shard(0) else Replicate() for p in q_pl]
    h = q.shape[1]
    heads_loc = local_block(mesh, q_pl, 1, h)[1]
    sel = _select_kv(h, heads_loc, _heads_offset(mesh, q_pl, h), k.shape[1],
                     any(p == Shard(1) for p in kv_pl))
    if not isinstance(cur_pos, DTensor):
        cur_pos = DTensor.from_local(cur_pos, mesh,
                                     [Replicate()] * mesh.ndim,
                                     run_check=False)

    def pick(kl):
        return kl if sel is None else kl[:, sel]

    return q_pl, kv_pl, pos_pl, pick, cur_pos


def ring_attention(q, k, v, cur_pos, window: int, plain):
    """The sliding-window ring decode (``plain``, plain torch) on
    DTensors: local per batch row and head where the ring is whole on
    each device; a ring split over its slots runs ``plain`` on the
    DTensors as they are (DTensor reduces its softmax)."""
    from ..dist.sharding import split_devices

    if split_devices(k, 2) > 1:
        return plain(q, k, v, cur_pos, window)
    q_pl, kv_pl, pos_pl, pick, cur_pos = _decode_layout(q, k, cur_pos, [])
    return on_shards(
        lambda ql, kl, vl, pl: plain(ql, pick(kl), pick(vl), pl, window),
        (q, k, v, cur_pos), (q_pl, kv_pl, kv_pl, pos_pl), q.device_mesh,
        (q_pl,), (tuple(q.shape[:3]) + (v.shape[-1],),))


def decode_attention(q, k, v, cur_pos, *, window=0):
    """K4 on DTensors: q [B, H, hd], caches [B, KV, S, hd], ``cur_pos``
    [B].  A cache split over its sequence is attended shard by shard
    and the partial softmaxes combined across the shards."""
    Partial, _, Shard = _placements()

    mesh = q.device_mesh
    seq_dims = [i for i, p in enumerate(k.placements)
                if p == Shard(2) and mesh.size(i) > 1]
    q_pl, kv_pl, pos_pl, pick, cur_pos = _decode_layout(q, k, cur_pos,
                                                        seq_dims)
    h = q.shape[1]
    if not seq_dims:
        return on_shards(
            lambda ql, kl, vl, pl: ops.decode_attention(
                ql, pick(kl), pick(vl), pl, window=window),
            (q, k, v, cur_pos), (q_pl, kv_pl, kv_pl, pos_pl), mesh, (q_pl,),
            (tuple(q.shape[:2]) + (v.shape[-1],),))

    first, _ = local_block(mesh, kv_pl, 2, k.shape[2])
    b = q.shape[0]

    def logits(ql, kl, pl):
        kl = pick(kl)
        kf = repeat_kv(kl, ql.shape[1] // kl.shape[1]).float()
        out = torch.einsum("bhd,bhkd->bhk", ql.float(), kf)
        out = out / float(ql.shape[-1]) ** 0.5
        k_pos = first + torch.arange(kl.shape[2], device=ql.device)
        cur = pl.reshape(-1, 1).long()
        mask = k_pos[None, :] <= cur
        if window > 0:
            mask &= k_pos[None, :] > (cur - window)
        return torch.where(mask[:, None, :], out, NEG_INF)

    l_pl = [Shard(2) if i in seq_dims else p for i, p in enumerate(q_pl)]
    lg = on_shards(logits, (q, k, cur_pos), (q_pl, kv_pl, pos_pl), mesh,
                   (l_pl,), ((b, h, k.shape[2]),))
    m = lg.amax(dim=-1, keepdim=True)
    w = torch.exp(lg - m)
    z = w.sum(dim=-1, keepdim=True)

    def weighted(wl, vl):
        vl = pick(vl)
        vf = repeat_kv(vl, wl.shape[1] // vl.shape[1]).float()
        return torch.einsum("bhk,bhkd->bhd", wl, vf)

    o_pl = [Partial() if i in seq_dims else p for i, p in enumerate(q_pl)]
    o = on_shards(weighted, (w, v), (l_pl, kv_pl), mesh, (o_pl,),
                  ((b, h, v.shape[-1]),))
    return (o / z).to(q.dtype)


def grouped_matmul(x, w):
    """K5 on DTensors: x [E, C, D] @ w [E, D, F] per expert, split over
    the experts, x's rows and w's columns; the contraction is whole."""
    _, Replicate, Shard = _placements()
    mesh = x.device_mesh
    x_pl, w_pl, o_pl = [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if Shard(0) in (xp, wp):
            x_pl.append(Shard(0)), w_pl.append(Shard(0)), o_pl.append(Shard(0))
        elif xp == Shard(1):
            x_pl.append(xp), w_pl.append(Replicate()), o_pl.append(Shard(1))
        elif wp == Shard(2):
            x_pl.append(Replicate()), w_pl.append(wp), o_pl.append(Shard(2))
        else:
            x_pl.append(Replicate()), w_pl.append(Replicate())
            o_pl.append(Replicate())
    shape = (x.shape[0], x.shape[1], w.shape[2])
    return on_shards(ops.grouped_matmul, (x, w), (x_pl, w_pl), mesh, (o_pl,),
                     (shape,))


def ssd_scan(x, dt, A, Bm, C, chunk):
    """K6 on DTensors: x [b, s, nh, hd], dt [b, s, nh], A [nh], B and C
    [b, s, ds], split over the batch and the heads."""
    bh = {"batch": 0, "heads": 2}
    rows = {"batch": 0}
    return by_roles(lambda *t: ops.ssd_scan(*t, chunk), (x, dt, A, Bm, C),
                    (bh, bh, {"heads": 0}, rows, rows), (bh,),
                    (tuple(x.shape),))


def write_at(cache, new, at, seq_dim: int) -> None:
    """``cache[r, ..., at[r], ...] = new[r]`` for every batch row r, in
    place, on DTensors: each device writes the rows it holds where the
    position falls in its part of the sequence (a cache split over its
    sequence is written on one device of the split).  ``new`` is the
    cache's shape without dim ``seq_dim``; ``at`` [B] the positions."""
    from torch.distributed.tensor import DTensor

    _, Replicate, Shard = _placements()
    mesh = cache.device_mesh
    new_pl, at_pl = [], []
    for p in cache.placements:
        if p == Shard(seq_dim):
            new_pl.append(Replicate())
        elif isinstance(p, Shard):
            new_pl.append(Shard(p.dim - (p.dim > seq_dim)))
        else:
            new_pl.append(Replicate())
        at_pl.append(p if p == Shard(0) else Replicate())
    local = cache.to_local()
    first, _ = local_block(mesh, cache.placements, seq_dim,
                           cache.shape[seq_dim])
    if not isinstance(at, DTensor):
        at = DTensor.from_local(at, mesh, [Replicate()] * mesh.ndim,
                                run_check=False)
    new_l = new.redistribute(mesh, new_pl).to_local()
    at_l = at.redistribute(mesh, at_pl).to_local().long() - first
    here = (at_l >= 0) & (at_l < local.shape[seq_dim])
    rows = torch.arange(local.shape[0], device=local.device)
    at_l = at_l.clamp(0, local.shape[seq_dim] - 1)
    view = local.movedim(seq_dim, 1)  # [B, S, ...]: a view of the shard
    keep = here.reshape((-1,) + (1,) * (new_l.dim() - 1))
    view[rows, at_l] = torch.where(keep, new_l.to(local.dtype),
                                   view[rows, at_l])
