"""Train step: causal-LM loss, gradient accumulation (microbatching),
AdamW — the JAX package's ``repro.train.train_step`` on torch tensors.

JAX's step is a pure jitted function whose microbatches run as a
``lax.scan``; here the step is eager: the microbatches run as a loop,
each one's loss differentiated by ``torch.autograd.grad`` with respect
to every parameter leaf (remat applies per unit of layers inside the
model), their gradients summed in f32.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch
from torch.utils import checkpoint as _ckpt

from .. import obs
from ..configs.base import ArchConfig
from ..dist.sharding import local_block, on_shards, shard, split_devices
from ..models.transformer import forward, forward_hidden, unembed_weight
from ..optim import adamw
from ..tree import tree_flatten, tree_unflatten

PyTree = Any


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the next-token NLL over non-padding positions, their
    count): label -1 is padding."""
    if split_devices(logits, -1) > 1:
        return _nll_sum_split(logits, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    mask = (labels >= 0).float()
    safe = labels.clamp_min(0).long()
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return torch.sum(nll * mask), torch.sum(mask)


def _nll_sum_split(logits: torch.Tensor, labels: torch.Tensor):
    """``_nll_sum`` of DTensor logits whose vocabulary is split across
    devices, without gathering it (as XLA partitions the reference's
    ``log_softmax`` and label gather): the log-sum-exp from an
    all-reduced maximum and sum, and each label's logit picked on the
    device that holds it and summed across the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rows = ("batch", "seq")
    lf = logits.float()
    m = shard(lf.amax(dim=-1), rows).detach()
    lse = torch.log(shard(torch.exp(lf - m[..., None]).sum(dim=-1), rows)) + m
    mesh = logits.device_mesh
    v_dim = logits.dim() - 1
    first, _ = local_block(mesh, logits.placements, v_dim, logits.shape[-1])
    safe = labels.clamp_min(0).long()

    def pick(ll, lab):
        idx = lab - first
        here = (idx >= 0) & (idx < ll.shape[-1])
        got = ll.gather(-1, idx.clamp(0, ll.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(here, got, 0.0)

    pl = [Partial() if p == Shard(v_dim) else p for p in lf.placements]
    lab_pl = [Replicate() if p == Shard(v_dim) else p
              for p in lf.placements]
    picked = on_shards(pick, (lf, safe), (lf.placements, lab_pl), mesh,
                       (pl,), (tuple(lf.shape[:-1]),))
    mask = (labels >= 0).float()
    nll = lse - shard(picked, rows)
    return torch.sum(nll * mask), torch.sum(mask)


def _chunk_nll(h: torch.Tensor, lab: torch.Tensor, w: torch.Tensor):
    """One chunk of the chunked-vocab loss: f32 logits of [B, chunk, d]
    against the unembedding, then its NLL sum and token count."""
    logits = torch.matmul(h.float(), w.float())
    return _nll_sum(logits, lab)


def lm_loss(
    cfg: ArchConfig,
    params,
    batch: Dict[str, torch.Tensor],
    *,
    remat: Union[bool, str] = True,
    loss_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Next-token cross-entropy, mean over non-padding positions.

    ``loss_chunk`` enables the chunked-vocab loss: the [B, S, vocab] f32
    logits are never materialised — each chunk of ``loss_chunk``
    positions runs under ``torch.utils.checkpoint``, its logits
    recomputed in the backward, so one [B, chunk, V] f32 tensor lives at
    a time in either pass (JAX: a ``jax.checkpoint``-ed ``lax.scan``).
    """
    tokens = batch["tokens"]
    labels = batch["labels"]
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    if loss_chunk is None:
        logits = forward(cfg, params, tokens, extra=extra or None,
                         remat=remat)
        # modality frontends prepend positions (vision tokens): the loss
        # runs on the trailing text positions only
        if logits.shape[1] != labels.shape[1]:
            logits = logits[:, -labels.shape[1]:]
        nll_sum, n_tok = _nll_sum(logits, labels)
        return nll_sum / torch.clamp_min(n_tok, 1.0)

    hidden = forward_hidden(cfg, params, tokens, extra=extra or None,
                            remat=remat)
    if hidden.shape[1] != labels.shape[1]:
        hidden = hidden[:, -labels.shape[1]:]
    w = unembed_weight(cfg, params)
    s = hidden.shape[1]
    chunk = min(loss_chunk, s)
    nll_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n_tok = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        h, lab = hidden[:, start:start + chunk], labels[:, start:start + chunk]
        if torch.is_grad_enabled():
            c_sum, c_n = _ckpt.checkpoint(_chunk_nll, h, lab, w,
                                          use_reentrant=False)
        else:
            c_sum, c_n = _chunk_nll(h, lab, w)
        nll_sum = nll_sum + c_sum
        n_tok = n_tok + c_n
    return nll_sum / torch.clamp_min(n_tok, 1.0)


def value_and_grad(cfg: ArchConfig, params, batch, *,
                   remat: Union[bool, str] = True,
                   loss_chunk: Optional[int] = None):
    """(loss, grads): ``lm_loss`` and its gradient with respect to every
    parameter leaf, as a tree like ``params`` in the leaves' dtypes (JAX's
    ``value_and_grad``).  Leaves are made to require a gradient (they are
    the trainer's own tensors); a leaf the loss does not reach gets
    zeros."""
    leaves, treedef = tree_flatten(params)
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    with torch.enable_grad():
        with obs.span("train.forward"):
            loss = lm_loss(cfg, params, batch, remat=remat,
                           loss_chunk=loss_chunk)
        with obs.span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(treedef, grads)


def pin_batch(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Pin every batch entry's leading axis to the data axis before any
    compute (each entry is returned as it is unless a
    ``repro_torch.dist.sharding`` rules context is active)."""
    return {k: shard(v, ("batch",) + (None,) * (v.dim() - 1))
            for k, v in batch.items()}


def make_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    microbatches: int = 1,
    remat: Union[bool, str] = True,
    loss_chunk: Optional[int] = None,
):
    """Build a (params, opt_state, batch) → (params, opt_state, metrics)
    step with ``microbatches``-way gradient accumulation: microbatch i is
    rows [i·B/n, (i+1)·B/n) of every batch entry; the losses and the f32
    gradients are summed over the microbatches and divided by their
    count.  The parameters and moments are updated in place."""

    def train_step(params, opt_state: adamw.AdamWState, batch):
        with obs.span("train.step"):
            batch = pin_batch(batch)
            if microbatches == 1:
                with obs.span("train.microbatch", index=0):
                    loss, grads = value_and_grad(
                        cfg, params, batch, remat=remat,
                        loss_chunk=loss_chunk)
            else:
                n = next(iter(batch.values())).shape[0] // microbatches
                loss = None
                acc = None
                for i in range(microbatches):
                    with obs.span("train.microbatch", index=i):
                        micro = {k: v[i * n:(i + 1) * n]
                                 for k, v in batch.items()}
                        l, g = value_and_grad(cfg, params, micro, remat=remat,
                                              loss_chunk=loss_chunk)
                        g_leaves, treedef = tree_flatten(g)
                        if acc is None:
                            loss = l.float()
                            acc = [x.float() for x in g_leaves]
                        else:
                            loss = loss + l
                            for a, x in zip(acc, g_leaves):
                                a.add_(x.float())
                        del g, g_leaves
                loss = loss / microbatches
                for a in acc:
                    a.div_(microbatches)
                grads = tree_unflatten(treedef, acc)
            new_params, new_opt, gnorm = adamw.update(
                opt_cfg, grads, opt_state, params)
            metrics = {"loss": loss, "grad_norm": gnorm, "step": new_opt.step}
            return new_params, new_opt, metrics

    return train_step
