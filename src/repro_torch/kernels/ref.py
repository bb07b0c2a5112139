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
