"""Granite-3.0 MoE (huggingface.co/ibm-granite/granite-3.0-3b-a800m-base)
as a plain float32 decoder: InternLM2's attention stack
(``internlm2.py``), tied embeddings, and a token-choice top-k mixture of
gated-SiLU experts in every layer.

The MoE follows the model as the port configures it, which departs from
the published one in two ways the configuration file states: the router's
softmax over all experts picks the top k (ties to the lower index), and
the k chosen probabilities are renormalised by a softmax over them; and
each sequence gives every expert a capacity of ``max(8, min(ceil(S k / E
cf), S))`` tokens, the tokens past it dropped in order of position.  The
published model's scalar multipliers (embedding, residual, attention and
logits) are not in the port's model, nor here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .internlm2 import mm

#: the gap read where the side judged made no choice for a token the
#: reference routes (its choices do not cover the batch)
UNCHOSEN = 1e9


def capacity(m: dict, s: int) -> int:
    c = math.ceil(s * m["num_experts_per_tok"] / m["num_local_experts"]
                  * m["capacity_factor"])
    return max(8, min(c, s))


class Routes:
    """The experts chosen in one step, layer by layer, [B, S, k] each
    (their order within a token does not matter).  With ``given`` (the
    choices of the side judged) the reference follows them, so that a
    near-tie the two sides break apart moves neither's gradients, and
    ``gap`` keeps the widest amount by which a followed choice's router
    log-probability lies below the reference's own k-th best: the
    choices are judged as a served model's tokens are.  Where ``given`` does not cover the batch, the
    reference chooses for itself and the gap reads ``UNCHOSEN``.
    Without, it chooses its own and keeps them in ``chosen``."""

    def __init__(self, given=None):
        self.given = given
        self.chosen = {}
        self.gap = 0.0


def moe(m: dict, w: dict, i: int, h: torch.Tensor, lowp: bool,
        routes: Routes = None):
    """h [B, S, d]: each sequence dispatched on its own.  An entry (token
    s, choice j) takes the position in its expert's queue given by how
    many entries before it, in order of (s, j), chose the same expert;
    positions past the capacity are dropped."""
    B, S, d = h.shape
    E, k = m["num_local_experts"], m["num_experts_per_tok"]
    probs = torch.softmax(mm(h, w["router"][i], lowp), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    given = routes.given if routes is not None else None
    if given is not None and (given[i] is None
                              or given[i].shape != (B, S, k)):
        routes.gap, given = UNCHOSEN, None
    if given is not None:
        chosen = given[i].to(h.device).long()
        p = probs.gather(-1, chosen)
        with torch.no_grad():
            gap = (vals[..., k - 1:k].log() - p.log()).max()
        routes.gap = max(routes.gap, float(gap))
    else:
        chosen, p = idx[..., :k], vals[..., :k]
        if routes is not None:
            routes.chosen[i] = chosen.detach().to(torch.uint8)
    top_w = torch.softmax(p, dim=-1).reshape(B, S * k)
    expert = chosen.reshape(B, S * k)
    cap = capacity(m, S)
    onehot = F.one_hot(expert, E)
    pos = (onehot.cumsum(dim=1) - 1).gather(2, expert[..., None])[..., 0]
    keep = pos < cap
    # row of each kept entry in [B, E, cap]; dropped entries go to a spare
    row = torch.where(keep, expert * cap + pos, E * cap)
    xs = h.repeat_interleave(k, dim=1)  # [B, S k, d], entries in (s, j) order
    xe = h.new_zeros(B, E * cap + 1, d).scatter(
        1, row[..., None].expand(B, S * k, d), xs)
    xe = xe[:, : E * cap].reshape(B, E, cap, d).transpose(0, 1)
    xe = xe.reshape(E, B * cap, d)
    ye = mm(F.silu(mm(xe, w["gate"][i], lowp)) * mm(xe, w["up"][i], lowp),
            w["down"][i], lowp)  # [E, B cap, d]
    ye = ye.reshape(E, B, cap, d).transpose(0, 1).reshape(B, E * cap, d)
    ye = torch.cat([ye, ye.new_zeros(B, 1, d)], dim=1)
    out = ye.gather(1, row[..., None].expand(B, S * k, d))
    out = out * (top_w * keep)[..., None]
    return out.reshape(B, S, k, d).sum(dim=2)


FFN = moe
