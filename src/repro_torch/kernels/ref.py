"""Plain PyTorch versions of the kernels (the correctness reference).

They mirror the JAX package's jnp code: f32 einsums, a masked softmax
with the finite ``NEG_INF`` (a fully masked row averages V over every key
instead of giving NaN), output in q's dtype (in x's dtype for the
grouped matmul, f32 for the SSD scan).  The paged versions gather
each row's pages first; the attention versions take grouped-query K/V
``[B, KV, S, hd]`` and repeat it to the q heads, as
``repro.models.layers`` does.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, kv, S, hd] → [B, kv*groups, S, hd] (GQA head replication)."""
    if groups == 1:
        return k
    b, kv, s, hd = k.shape
    return k[:, :, None].expand(b, kv, groups, s, hd).reshape(
        b, kv * groups, s, hd
    )


def flash_attention_ref(
    q: torch.Tensor,  # [B, H, Sq, hd]
    k: torch.Tensor,  # [B, KV, Sk, hd]
    v: torch.Tensor,  # [B, KV, Sk, vd]: vd may be narrower (MLA)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = no sliding window
    q_offset: int = 0,
    chunk: int = 512,
) -> torch.Tensor:
    """K3's plain version: ``repro.models.layers.chunked_attention``, one
    block of ``chunk`` query rows at a time against the full masked K
    (peak memory O(chunk × Sk)).  Row i sits at position q_offset + i;
    key j is kept when j <= that position (causal) and it is less than
    ``window`` behind (window > 0).  The scale is 1/sqrt(q's width) and
    the output is V's width.  A row that keeps no key returns the
    mean of V over all Sk keys, as the Pallas kernel does
    (``repro.kernels.ref.flash_attention_ref`` returns 0 there)."""
    b, h, sq, hd = q.shape
    groups = h // k.shape[1]
    k = repeat_kv(k, groups).float()
    v_f = repeat_kv(v, groups).float()
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    k_pos = torch.arange(sk, device=q.device)
    outs = []
    for start in range(0, sq, chunk):
        q_blk = q[:, :, start:start + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", q_blk, k) * scale
        q_pos = q_offset + start + torch.arange(
            q_blk.shape[2], device=q.device
        )
        mask = torch.ones(
            (q_blk.shape[2], sk), dtype=torch.bool, device=q.device
        )
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        logits = torch.where(mask[None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", probs, v_f).to(q.dtype))
    return torch.cat(outs, dim=2)


def decode_attention_ref(
    q: torch.Tensor,  # [B, H, hd]
    k: torch.Tensor,  # [B, KV, S, hd]
    v: torch.Tensor,
    cur_pos: torch.Tensor,  # [B] (or [1]): row b attends [0, cur_pos[b]]
    *,
    window: int = 0,  # 0 = no sliding window
) -> torch.Tensor:
    """K4's plain version: ``repro.models.layers.decode_attention`` with a
    position per row (the JAX package takes one scalar and vmaps over
    slots); with ``window`` only keys after cur_pos − window count."""
    h, hd = q.shape[1], q.shape[2]
    groups = h // k.shape[1]
    k = repeat_kv(k, groups)
    v = repeat_kv(v, groups)
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum(
        "bhqd,bhkd->bhqk", q[:, :, None].float(), k.float()
    ) * scale
    k_pos = torch.arange(sk, device=q.device)
    cur = cur_pos.to(q.device).reshape(-1, 1)  # [B|1, 1]
    mask = k_pos[None, :] <= cur
    if window > 0:
        mask &= k_pos[None, :] > (cur - window)
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out[:, :, 0].to(q.dtype)


def paged_decode_attention_ref(
    q: torch.Tensor,  # [BH, hd]
    k_pool: torch.Tensor,  # [n_pages, page, hd]
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [BH, max_pages] int32
    seq_lens: torch.Tensor,  # [BH] int32
) -> torch.Tensor:
    """Gather-based reference: materialize each row's KV, then attend."""
    bh, hd = q.shape
    page = k_pool.shape[1]
    max_pages = page_table.shape[1]
    idx = page_table.long()
    k = k_pool[idx].reshape(bh, max_pages * page, hd)
    v = v_pool[idx].reshape(bh, max_pages * page, hd)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bd,bkd->bk", q.float(), k.float()) * scale
    tok = torch.arange(max_pages * page, device=q.device)[None, :]
    s = torch.where(tok < seq_lens[:, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bk,bkd->bd", p, v.float()).to(q.dtype)


def paged_decode_attention_int8_ref(
    q: torch.Tensor,  # [BH, hd]
    k_pool: torch.Tensor,  # [n_pages, page, hd] int8 codes
    v_pool: torch.Tensor,
    k_scales: torch.Tensor,  # [n_pages] f32
    v_scales: torch.Tensor,
    page_table: torch.Tensor,  # [BH, max_pages]
    seq_lens: torch.Tensor,  # [BH]
) -> torch.Tensor:
    """Dequantize the whole pool up front, then run the f32 reference."""
    k = k_pool.float() * k_scales[:, None, None]
    v = v_pool.float() * v_scales[:, None, None]
    return paged_decode_attention_ref(q, k, v, page_table, seq_lens)


def grouped_matmul_ref(
    x: torch.Tensor,  # [E, C, D]
    w: torch.Tensor,  # [E, D, F]
) -> torch.Tensor:
    """K5's plain version: ``y[e] = x[e] @ w[e]`` in f32, output in x's
    dtype (``repro.kernels.ref.grouped_matmul_ref``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def grouped_matmul_bwd_ref(
    x: torch.Tensor,  # [E, C, D]
    w: torch.Tensor,  # [E, D, F]
    dy: torch.Tensor,  # [E, C, F]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's backward's plain version: ``dx[e] = dy[e] @ w[e]^T`` and
    ``dw[e] = x[e]^T @ dy[e]``, each in f32 and rounded once to x's dtype:
    the products autodiff of :func:`grouped_matmul_ref` runs."""
    xf, wf, dyf = x.float(), w.float(), dy.float()
    dx = torch.bmm(dyf, wf.transpose(1, 2))
    dw = torch.bmm(xf.transpose(1, 2), dyf)
    return dx.to(x.dtype), dw.to(x.dtype)


def ssd_scan_ref(
    x: torch.Tensor,  # [B, S, nh, hd]
    dt: torch.Tensor,  # [B, S, nh] f32, post-softplus
    A: torch.Tensor,  # [nh] f32, negative
    Bm: torch.Tensor,  # [B, S, ds]
    C: torch.Tensor,  # [B, S, ds]
    chunk: int,
) -> torch.Tensor:
    """K6's plain version: the Mamba-2 chunked SSD scan, step for step as
    ``repro.models.blocks._ssd_scan`` (the function the JAX model runs),
    in f32.  S is zero-padded up to a multiple of ``chunk`` (a pad
    position has dt = 0, so it neither decays nor feeds the state) and
    the pad rows are sliced off again.  Returns y [B, S, nh, hd] f32,
    without the D-skip and the gate."""
    b, s, nh, hd = x.shape
    ds = Bm.shape[-1]
    nc = (s + chunk - 1) // chunk
    pad = nc * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    xc = x.reshape(b, nc, chunk, nh, hd).float()
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bc = Bm.reshape(b, nc, chunk, ds).float()
    Cc = C.reshape(b, nc, chunk, ds).float()

    dA = dtc * A.float()[None, None, None, :]  # [b, nc, q, nh] (negative)
    seg = torch.cumsum(dA, dim=2)  # cumulative decay within the chunk
    total = seg[:, :, -1, :]  # [b, nc, nh]

    # intra-chunk, attention form; mask BEFORE exp (the upper triangle's
    # rel is large and positive and would overflow to inf)
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # [b,nc,qi,qj,nh]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device)
    causal = torch.tril(causal)[None, None, :, :, None]
    L = torch.exp(torch.where(causal, rel, float("-inf")))
    scores = torch.einsum("bcid,bcjd->bcij", Cc, Bc)
    M = scores[..., None] * L * dtc[:, :, None, :, :]  # [b,nc,qi,qj,nh]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xc)

    # per-chunk outgoing state  S_c = sum_j exp(total - seg_j) dt_j B_j x_j
    decay_out = torch.exp(total[:, :, None, :] - seg)  # [b, nc, q, nh]
    wx = (decay_out * dtc)[..., None] * xc  # [b, nc, q, nh, hd]
    S_c = torch.einsum("bcqd,bcqhp->bchpd", Bc, wx)  # [b, nc, nh, hd, ds]

    # inter-chunk recurrence  H_c = exp(total_c) H_{c-1} + S_c; chunk c
    # reads the state that came IN
    H = torch.zeros(b, nh, hd, ds, dtype=torch.float32, device=x.device)
    H_in = []
    for c in range(nc):
        H_in.append(H)
        H = torch.exp(total[:, c])[:, :, None, None] * H + S_c[:, c]
    H_in = torch.stack(H_in, dim=1)  # [b, nc, nh, hd, ds]

    # inter-chunk contribution  y_i += exp(seg_i) C_i . H_in
    y_inter = torch.einsum("bcqd,bchpd->bcqhp", Cc, H_in) * torch.exp(
        seg
    )[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, nh, hd)
    return y[:, :s] if pad else y


def ssd_scan_bwd_ref(
    x: torch.Tensor,  # [B, S, nh, hd]
    dt: torch.Tensor,  # [B, S, nh] f32, post-softplus
    A: torch.Tensor,  # [nh] f32, negative
    Bm: torch.Tensor,  # [B, S, ds]
    C: torch.Tensor,  # [B, S, ds]
    dy: torch.Tensor,  # [B, S, nh, hd]: the cotangent of y
    chunk: int,
):
    """K6's backward written out, in the order of work of its kernel
    (``csrc/ssd_scan_bwd.cu``), f32: returns (dx, ddt, dA, dB, dC), the
    gradients of :func:`ssd_scan_ref`'s y under ``dy``.  Per chunk c and
    head, with seg the running sum of dt A in the chunk, total its last
    value, M_ij = (C_i . B_j) exp(seg_i - seg_j) dt_j (j <= i), H_in the
    state [hd, ds] that enters the chunk and u_j = exp(total - seg_j) dt_j:

    1. the chunk's seg and total, its outgoing state S_c = sum_j u_j x_j
       B_j^T and G_c = sum_i exp(seg_i) dy_i C_i^T;
    2. the recurrences: H_in(c + 1) = exp(total_c) H_in(c) + S_c forward,
       dH_in(c) = exp(total_c) dH_in(c + 1) + G_c backward, and the
       outgoing state's gradient dS_c = dH_in(c + 1);
    3. intra-chunk, from dM_ij = dy_i . x_j: dx_j += sum_i M_ij dy_i;
       per head ds_ij = dM_ij exp(seg_i - seg_j) dt_j, dC_i += sum_j ds_ij
       B_j and dB_j += sum_i ds_ij C_i; ddt_j += sum_i dM_ij (C_i . B_j)
       exp(seg_i - seg_j); W_ij = dM_ij M_ij gives dseg_i += sum_j W_ij
       and dseg_j -= sum_i W_ij.  Inter-chunk: dC_i += exp(seg_i)
       H_in^T dy_i, and dseg_i += C_i . that (= dy_i . y_inter_i).  The
       outgoing state, v_j = x_j^T dS_c and q_j = v_j . B_j: dx_j += u_j
       dS_c B_j, dB_j += u_j v_j, ddt_j += exp(total - seg_j) q_j,
       dseg_j -= u_j q_j, dtotal += sum_j u_j q_j + exp(total) <dS_c,
       H_in(c)>;
    4. dtotal joins the last position's dseg; d(dt A)_t = sum_{i >= t}
       dseg_i in the chunk, ddt_t += d(dt A)_t A, dA = sum_{b,t} d(dt A)_t
       dt_t; dB and dC summed over the heads.

    A ragged last chunk is zero padding with dt = 0, as in the forward:
    every term of a pad position is 0 and its rows are sliced off."""
    b, s, nh, hd = x.shape
    ds = Bm.shape[-1]
    nc = (s + chunk - 1) // chunk
    pad = nc * chunk - s
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dy = torch.nn.functional.pad(dy, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        Bm = torch.nn.functional.pad(Bm, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    xc = x.reshape(b, nc, chunk, nh, hd).float()
    dyc = dy.reshape(b, nc, chunk, nh, hd).float()
    dtc = dt.reshape(b, nc, chunk, nh).float()
    Bc = Bm.reshape(b, nc, chunk, ds).float()
    Cc = C.reshape(b, nc, chunk, ds).float()
    Af = A.float()

    # 1. seg, total, the outgoing state S_c and G_c  [b, nc, nh, hd, ds]
    seg = torch.cumsum(dtc * Af, dim=2)  # [b, nc, q, nh]
    total = seg[:, :, -1, :]
    u = torch.exp(total[:, :, None, :] - seg) * dtc
    S_c = torch.einsum("bcqd,bcqhp->bchpd", Bc, u[..., None] * xc)
    e_in = torch.exp(seg)
    G_c = torch.einsum("bcqd,bcqhp->bchpd", Cc, e_in[..., None] * dyc)

    # 2. H_in(c) forward, dS_c = dH_in(c + 1) backward
    decay = torch.exp(total)[..., None, None]  # [b, nc, nh, 1, 1]
    H = torch.zeros(b, nh, hd, ds, dtype=torch.float32, device=x.device)
    H_in = []
    for c in range(nc):
        H_in.append(H)
        H = decay[:, c] * H + S_c[:, c]
    H_in = torch.stack(H_in, dim=1)
    dH = torch.zeros_like(H)
    dS = [None] * nc
    for c in reversed(range(nc)):
        dS[c] = dH
        dH = decay[:, c] * dH + G_c[:, c]
    dS = torch.stack(dS, dim=1)

    # 3. intra-chunk, masked before the exp as the forward
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # [b,nc,qi,qj,nh]
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device)
    causal = torch.tril(causal)[None, None, :, :, None]
    L = torch.exp(torch.where(causal, rel, float("-inf")))
    scores = torch.einsum("bcid,bcjd->bcij", Cc, Bc)
    M = scores[..., None] * L * dtc[:, :, None, :, :]
    dM = torch.einsum("bcihp,bcjhp->bcijh", dyc, xc)
    dx = torch.einsum("bcijh,bcihp->bcjhp", M, dyc)
    dsc = dM * L * dtc[:, :, None, :, :]
    dC = torch.einsum("bcijh,bcjd->bcid", dsc, Bc)
    dB = torch.einsum("bcijh,bcid->bcjd", dsc, Cc)
    ddt = torch.einsum("bcijh,bcij->bcjh", dM * L, scores)
    W = dM * M
    dseg = W.sum(dim=3) - W.sum(dim=2)  # [b, nc, q, nh]
    # inter-chunk
    dC_in = torch.einsum("bcqhp,bchpd->bcqhd", dyc, H_in) * e_in[..., None]
    dC = dC + dC_in.sum(dim=3)
    dseg = dseg + torch.einsum("bcqhd,bcqd->bcqh", dC_in, Cc)
    # the outgoing state
    dx = dx + u[..., None] * torch.einsum("bchpd,bcqd->bcqhp", dS, Bc)
    v = torch.einsum("bcqhp,bchpd->bcqhd", xc, dS)
    dB = dB + (u[..., None] * v).sum(dim=3)
    q = torch.einsum("bcqhd,bcqd->bcqh", v, Bc)
    ddt = ddt + torch.exp(total[:, :, None, :] - seg) * q
    dseg = dseg - u * q
    dtotal = (u * q).sum(dim=2) + torch.exp(total) * (dS * H_in).sum(
        dim=(-2, -1))

    # 4. the cumsum's gradient, dA, and the pad rows sliced off
    dseg[:, :, -1] += dtotal
    d_dA = torch.flip(torch.cumsum(torch.flip(dseg, [2]), dim=2), [2])
    ddt = ddt + d_dA * Af
    dA = (d_dA * dtc).sum(dim=(0, 1, 2))
    dx = dx.reshape(b, nc * chunk, nh, hd)[:, :s]
    ddt = ddt.reshape(b, nc * chunk, nh)[:, :s]
    dB = dB.reshape(b, nc * chunk, ds)[:, :s]
    dC = dC.reshape(b, nc * chunk, ds)[:, :s]
    return dx, ddt, dA, dB, dC
