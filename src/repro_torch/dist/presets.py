"""Per-architecture sharding presets for the dry-run launcher.

``arch_overrides`` adapts the default logical-axis map to one
(architecture × mesh × shape) cell; ``batch_shardings`` resolves the input
tree (tokens/labels, modality stubs, decode caches) to
:class:`~repro_torch.dist.sharding.NamedSharding` s.
"""

from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ArchConfig, ShapeConfig
from ..tree import tree_map_with_path
from .sharding import MeshAxes, Rules, path_str

PyTree = Any


def arch_overrides(
    cfg: ArchConfig, mesh, shape: ShapeConfig
) -> Dict[str, MeshAxes]:
    """Logical-axis overrides for one (arch × mesh × shape) cell.

    Defaults already handle the dense case (batch over data(+pod), TP dims
    over model, fsdp over data); this adds the per-family deviations.
    """
    o: Dict[str, MeshAxes] = {}
    if cfg.moe is not None:
        # experts across the model axis; the expert-internal dim stays
        # unsharded by default (serve presets may move it onto "data")
        o["expert"] = "model"
        o["expert_mlp"] = None
    if shape.global_batch == 1:
        # long-context single-stream decode: nothing to shard over data via
        # the batch axis — pin the KV sequence axis there instead
        o["batch"] = None
        o["kv_seq"] = "data"
    if shape.kind == "decode" and cfg.n_kv_heads:
        # decode caches enter the step as arguments, whose shardings must
        # divide the dim exactly (unlike in-graph pins, which pad): GQA
        # head counts smaller than the model axis fall back to replicated
        # heads + model-sharded KV sequence
        model_size = dict(zip(mesh.mesh_dim_names, mesh.shape)).get("model", 1)
        if cfg.n_kv_heads % model_size:
            o["kv_heads"] = None
            o.setdefault("kv_seq", "model")
    return o


def _cache_axes(cfg: ArchConfig, core_ndim: int):
    """Logical axes for one cache leaf, ignoring a leading stack dim.

    ``models.init_cache``'s leaves: KV caches [B, kv_heads, S, hd]; MLA
    latents and rope keys [B, S, rank]; Mamba conv tails [B, tail, width]
    and SSD states [B, heads, hd, d_state].
    """
    if core_ndim == 4:
        return ("batch", "kv_heads", "kv_seq", None)
    if core_ndim == 3:
        # the middle axis is the KV sequence only for MLA latent caches;
        # for mamba conv tails it is a (tiny) window — keep it replicated
        return ("batch", "kv_seq" if cfg.mla is not None else None, None)
    return ("batch",) + (None,) * (core_ndim - 1)


def batch_shardings(cfg: ArchConfig, rules: Rules, specs: PyTree) -> PyTree:
    """NamedShardings for an input tree (train, prefill or decode)."""

    def one(key_path, leaf):
        path = path_str(key_path)
        ndim = leaf.dim()
        if ndim == 0:
            return rules.sharding(())
        if path.startswith("caches/"):
            # unit caches carry a leading stack (pattern-repeats) dim
            lead = 1 if path.startswith("caches/unit/") else 0
            axes = (None,) * lead + _cache_axes(cfg, ndim - lead)
        elif path.endswith("embeds"):  # modality stubs [B, T, d]
            axes = ("batch",) + (None,) * (ndim - 2) + ("embed",)
        else:  # tokens / labels / anything batched-first
            axes = ("batch",) + (None,) * (ndim - 1)
        return rules.fitted_sharding(axes, tuple(leaf.shape))

    return tree_map_with_path(one, specs)
