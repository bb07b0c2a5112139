"""Fake-tensor stand-ins for every model input — the dry-run contract.

``input_specs(cfg, shape)`` returns fake tensors (``FakeTensorMode``: a
shape, a dtype and a device, no storage) for the given (architecture ×
input-shape) cell, the counterpart of the JAX package's
``ShapeDtypeStruct`` s:

    train_*    → {tokens, labels}  (+ modality-stub embeddings)
    prefill_*  → {tokens}          (+ stubs)
    decode_* / long_* → {tokens [B,1], caches(seq_len), pos}

Fake tensors of two modes cannot meet in one operation, so every
function here makes its tensors in the fake mode already active, and in
a fresh one only when none is: enter one ``FakeTensorMode`` around the
specs and the step that consumes them.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models.transformer import init_cache, init_model


def _fake_mode():
    """A context that makes tensors fake: the active ``FakeTensorMode``'s
    (entering nothing), or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    if detect_fake_mode() is not None:
        return contextlib.nullcontext()
    return FakeTensorMode()


def _empty(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype)


def _stub_inputs(cfg: ArchConfig, batch: int, seq: int) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if cfg.frontend == "vision_stub":
        out["patch_embeds"] = _empty(
            (batch, cfg.vision_tokens, cfg.d_model), torch.bfloat16)
    if cfg.enc_layers:
        out["frame_embeds"] = _empty(
            (batch, seq // cfg.enc_seq_divisor, cfg.d_model), torch.bfloat16
        )
    return out


def train_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with _fake_mode():
        # enc-dec: the encoder sees the frames; the decoder trains on text
        s_tok = min(s // 8, 512) if cfg.enc_layers else s
        out = {
            "tokens": _empty((b, s_tok), torch.int32),
            "labels": _empty((b, s_tok), torch.int32),
        }
        out.update(_stub_inputs(cfg, b, s))
    return out


def prefill_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    with _fake_mode():
        if cfg.enc_layers:
            out = {"tokens": _empty((b, min(s // 8, 448)), torch.int32)}
            out.update(_stub_inputs(cfg, b, s))
            return out
        out = {"tokens": _empty((b, s), torch.int32)}
        if cfg.frontend == "vision_stub":
            out.update(_stub_inputs(cfg, b, s))
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Decode: one new token against a seq_len KV cache."""
    b, s = shape.global_batch, shape.seq_len
    with _fake_mode():
        caches = init_cache(cfg, b, s, device="cpu")
        if cfg.enc_layers:
            kv = (b, cfg.n_kv_heads, s // cfg.enc_seq_divisor, cfg.head_dim)
            caches["cross_kv"] = (_empty(kv, torch.bfloat16),
                                  _empty(kv, torch.bfloat16))
        return {
            "tokens": _empty((b, 1), torch.int32),
            "caches": caches,
            "pos": _empty((), torch.int32),
        }


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_specs(cfg, shape)
    return decode_specs(cfg, shape)


def model_state_specs(cfg: ArchConfig, *, with_opt: bool = True):
    """Fake (params, opt_state): ``init_model`` and ``adamw.init`` under
    the fake mode, so nothing is allocated."""
    from ..optim import adamw

    with _fake_mode():
        params = init_model(cfg, device="cpu")
        if not with_opt:
            return params
        return params, adamw.init(params)
