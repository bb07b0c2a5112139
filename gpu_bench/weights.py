"""Random weights made by the benchmark from ``--seed``, on the device.

One ``torch.randn`` call per stacked leaf (the layers' weights are stacked
on a leading layer axis, as the port keeps them), drawn in the served
dtype from one ``torch.Generator`` on the device.  The same seed gives
the same bits, so the reference regenerates the weights leaf by leaf
(:func:`leaves`) instead of keeping a copy.

Layout of a decoder of full-attention blocks with a dense gated-SiLU MLP
or a token-choice MoE: ``embed`` [V, d]; per layer ``ln1``, ``wq``,
``wk``, ``wv``, ``wo``, ``ln2`` and ``gate``/``up``/``down`` (MoE:
``router`` [d, E] in f32 and ``gate``/``up`` [E, d, f], ``down``
[E, f, d]); ``final_ln``; ``lm_head`` [d, V] unless the embedding is
tied.  Products are ``x @ w`` with ``w`` [in, out]; a norm's weight ``w``
scales by ``1 + w``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

#: scale of the embedding table's normal draw
EMBED_SCALE = 0.02
#: scale of a norm weight's draw (norms scale by 1 + w)
NORM_SCALE = 0.1


def layout(model: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, dtype, scale) of every leaf, in draw order."""
    d, L, V = model["hidden_size"], model["num_hidden_layers"], model["vocab_size"]
    H, KV, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                 model["head_dim"])
    bf = "bfloat16"
    out = [("embed", (V, d), bf, EMBED_SCALE),
           ("ln1", (L, d), bf, NORM_SCALE),
           ("wq", (L, d, H * hd), bf, d ** -0.5),
           ("wk", (L, d, KV * hd), bf, d ** -0.5),
           ("wv", (L, d, KV * hd), bf, d ** -0.5),
           ("wo", (L, H * hd, d), bf, (H * hd) ** -0.5),
           ("ln2", (L, d), bf, NORM_SCALE)]
    E = model.get("num_local_experts", 0)
    if E:
        f = model["intermediate_size"]
        out += [("router", (L, d, E), "float32", d ** -0.5),
                ("gate", (L, E, d, f), bf, d ** -0.5),
                ("up", (L, E, d, f), bf, d ** -0.5),
                ("down", (L, E, f, d), bf, f ** -0.5)]
    else:
        f = model["intermediate_size"]
        out += [("gate", (L, d, f), bf, d ** -0.5),
                ("up", (L, d, f), bf, d ** -0.5),
                ("down", (L, f, d), bf, f ** -0.5)]
    out.append(("final_ln", (d,), bf, NORM_SCALE))
    if not model.get("tie_word_embeddings", False):
        out.append(("lm_head", (d, V), bf, d ** -0.5))
    return out


def leaves(model: dict, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Each leaf in draw order, drawn in its own dtype: the caller keeps
    or drops it, so a regeneration holds one leaf at a time."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    for name, shape, dtype, scale in layout(model):
        w = torch.randn(shape, generator=gen, dtype=getattr(torch, dtype),
                        device=device)
        yield name, w.mul_(scale)


def make(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return dict(leaves(model, seed, device))


def program_tree(model: dict, w: Dict[str, torch.Tensor]) -> dict:
    """The port's parameter tree (``repro_torch.models.init_model``'s
    layout) over the same tensors."""
    ffn = ({"moe": {k: w[k] for k in ("router", "gate", "up", "down")}}
           if model.get("num_local_experts", 0)
           else {"mlp": {k: w[k] for k in ("gate", "up", "down")}})
    tree = {
        "embed": {"tokens": w["embed"]},
        "layers": {"b0": {
            "ln1": w["ln1"],
            "attn": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
            "ln2": w["ln2"], **ffn}},
        "suffix": [],
        "final_ln": w["final_ln"],
    }
    if "lm_head" in w:
        tree["lm_head"] = w["lm_head"]
    return tree


def program_leaves(model: dict, tree: dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`program_tree`: the port's tensors by the
    benchmark's leaf names."""
    b0 = tree["layers"]["b0"]
    ffn = b0.get("moe") or b0["mlp"]
    out = {"embed": tree["embed"]["tokens"], "ln1": b0["ln1"],
           **b0["attn"], "ln2": b0["ln2"], **ffn,
           "final_ln": tree["final_ln"]}
    if "lm_head" in tree:
        out["lm_head"] = tree["lm_head"]
    return {name: out[name] for name, _, _, _ in layout(model)}
