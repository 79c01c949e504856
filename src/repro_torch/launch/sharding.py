"""Sharding rules: param-tree path → PartitionSpec for every arch family.

Scheme (Megatron-style TP over "model", FSDP over "data", pure DP over "pod"):

- attention: wq/wk/wv shard the head output dim over model (iff the head
  count divides TP so the post-matmul reshape stays shard-aligned); wo shards
  its input dim.  MLA shards the latent-expansion weights per-head.
- MLP: wi/wg shard d_ff (column parallel); wo shards d_ff (row parallel) —
  one all-reduce per block, the classic pattern.
- MoE: experts shard over model (EP) when n_experts % tp == 0, else TP
  inside each expert over d_expert.
- embeddings / lm_head: vocab-sharded over model when divisible.
- FSDP: every leaf additionally shards its largest remaining dim over "data"
  when divisible — params, grads and Adam state all follow the same spec.
- anything that fails divisibility falls back to replication on that axis
  (correct, just less sharded), so every arch lays out on the fixed
  production mesh without per-arch tuning.

``pure_dp=True`` reproduces the paper's DDP exactly: params fully replicated,
batch sharded over every axis; used for the paper-faithful ST-GNN baseline.

The rules read only a :class:`~repro_torch.core.distributed.MeshSpec` (axis
names and sizes), so they run with no process group.  A
:class:`PartitionSpec` is a tuple with one entry per tensor dim — ``None``,
an axis name, or a tuple of names — equal as a tuple to the JAX package's
``PartitionSpec``; :func:`to_placements` turns it into DTensor placements on
a ``DeviceMesh``.  Those classes and :func:`constrain` live in
``core/distributed.py``, where the model reads them, and are re-exported
here beside the rules.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.core.distributed import (  # noqa: F401 — re-exported with the rules
    P, NamedSharding, PartitionSpec, as_spec, constrain, minor_split, to_placements)
from repro_torch.launch.mesh import dp_axes
from repro_torch.tree import tree_map, tree_map_with_path


# --------------------------------------------------------------------- helpers
def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _with_fsdp(spec: list, shape: tuple, mesh, fsdp_axes: tuple[str, ...],
               min_size: int = 2**16) -> list:
    """Add FSDP sharding on the largest unsharded dim (params >= min_size)."""
    if not fsdp_axes or int(math.prod(shape)) < min_size:
        return spec
    sizes = as_spec(mesh).shape
    fsdp_n = int(math.prod(sizes[a] for a in fsdp_axes))
    # largest dim not already sharded, divisible by the fsdp extent
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if spec[i] is None and _div(shape[i], fsdp_n):
            spec[i] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
            break
    return spec


def _dp_entry(dp: tuple[str, ...]):
    return dp if len(dp) > 1 else dp[0]


# ------------------------------------------------------------------- LM params
def lm_param_spec(path: str, shape: tuple, cfg, mesh, *,
                  fsdp: tuple[str, ...] = ("data",), tp_rules: bool = True) -> P:
    """PartitionSpec for one LM param leaf.

    ``shape`` includes the stage-stacking leading ``repeats`` dim for leaves
    under stages/ — rules index dims from the END so they hold for both.
    ``tp_rules=False`` disables tensor parallelism entirely (the 2D/ZeRO-3
    scheme: params fully FSDP-sharded, batch over every axis).
    """
    shape = tuple(shape)
    # tp=0 disables every TP rule branch (_div(n, 0) is False)
    tp = int(as_spec(mesh).shape.get("model", 1)) if tp_rules else 0
    nd = len(shape)
    spec: list = [None] * nd

    def last(i):  # index from the end
        return nd - i

    name = path.rsplit("/", 1)[-1]
    parent = path.rsplit("/", 2)[-2] if "/" in path else ""

    if "lm_head" in path:
        # [d, V]: vocab (last dim) sharded — column-parallel logits
        if _div(shape[-1], tp):
            spec[-1] = "model"
    elif "embed" in path or path == "pos":
        # [V, d] / [S, d]: vocab/position-sharded over model when divisible
        if _div(shape[0], tp):
            spec[0] = "model"
    elif "/attn/" in path and name == "w":
        if parent in ("wq", "wo"):
            heads_ok = _div(cfg.n_heads, tp)
            if parent == "wq" and heads_ok:
                spec[last(1)] = "model"  # column: [*, d, H*hd]
            elif parent == "wo" and heads_ok:
                spec[last(2)] = "model"  # row: [*, H*hd, d]
        elif parent in ("wk", "wv") and _div(cfg.n_kv_heads, tp):
            spec[last(1)] = "model"
        elif parent == "wq" and cfg.mla is not None and _div(cfg.n_heads, tp):
            spec[last(1)] = "model"
        elif parent in ("wukv",) and _div(cfg.n_heads, tp):
            spec[last(1)] = "model"
        # wdkv (latent down-proj) stays TP-replicated: its output is the cache
    elif "/attn/" in path and name == "b":
        if parent == "wq" and _div(cfg.n_heads, tp):
            spec[last(1)] = "model"
        elif parent in ("wk", "wv") and _div(cfg.n_kv_heads, tp):
            spec[last(1)] = "model"
    elif "/mlp/" in path and name == "w":
        dff = shape[last(1)] if parent in ("wi", "wg") else shape[last(2)]
        if parent in ("wi", "wg") and _div(dff, tp):
            spec[last(1)] = "model"
        elif parent == "wo" and _div(dff, tp):
            spec[last(2)] = "model"
    elif "/moe/" in path:
        if name == "w" and parent == "router":
            pass  # router stays replicated (tiny, f32)
        elif name in ("wi", "wg", "wo"):
            e = cfg.moe.n_experts
            de = cfg.moe.d_expert or cfg.d_ff
            if _div(e, tp):
                spec[last(3)] = "model"  # EP: [*, E, d, de]
            elif name in ("wi", "wg") and _div(de, tp):
                spec[last(1)] = "model"
            elif name == "wo" and _div(de, tp):
                spec[last(2)] = "model"
        elif "/shared/" in path and name == "w":
            dff = shape[last(1)] if parent in ("wi", "wg") else shape[last(2)]
            if parent in ("wi", "wg") and _div(dff, tp):
                spec[last(1)] = "model"
            elif parent == "wo" and _div(dff, tp):
                spec[last(2)] = "model"
    elif "/rec/" in path and name == "w":
        w_lru = cfg.lru_width or cfg.d_model
        if parent in ("in_x", "in_gate", "wa", "wx") and _div(w_lru, tp):
            spec[last(1)] = "model"
        elif parent == "out" and _div(w_lru, tp):
            spec[last(2)] = "model"
    elif "/rwkv/" in path and name == "w":
        if parent in ("wr", "wk", "wv", "wg", "cm_k", "cm_r") and _div(shape[last(1)], tp):
            spec[last(1)] = "model"
        elif parent in ("wo", "cm_v") and _div(shape[last(2)], tp):
            spec[last(2)] = "model"

    spec = _with_fsdp(spec, shape, mesh, fsdp)
    return P(*spec)


def lm_param_shardings(params_shape: Any, cfg, mesh, *,
                       fsdp: tuple[str, ...] = ("data",), pure_dp: bool = False,
                       tp_rules: bool = True):
    """NamedSharding tree congruent with the params tree (leaves: anything
    with a ``.shape``)."""
    mesh = as_spec(mesh)

    def one(path, leaf):
        if pure_dp:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, lm_param_spec(path, leaf.shape, cfg, mesh,
                                                 fsdp=fsdp, tp_rules=tp_rules))

    return tree_map_with_path(one, params_shape)


def opt_state_shardings(param_shardings: Any, mesh):
    """Adam m/v follow the param shardings; step is replicated."""
    return {"m": param_shardings, "v": param_shardings, "step": replicated(mesh)}


def state_shardings(param_shardings: Any, mesh):
    return {"params": param_shardings,
            "opt": opt_state_shardings(param_shardings, mesh)}


# ---------------------------------------------------------------- activations
def batch_spec(mesh, *, pure_dp: bool = False) -> P:
    axes = tuple(as_spec(mesh).axis_names) if pure_dp else dp_axes(mesh)
    return P(axes)


def batch_sharding(mesh, *, pure_dp: bool = False) -> NamedSharding:
    return NamedSharding(as_spec(mesh), batch_spec(mesh, pure_dp=pure_dp))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(as_spec(mesh), P())


# -------------------------------------------------------------------- caches
def cache_shardings(cache_shape: Any, cfg, mesh):
    """Decode caches: batch over data axes, long/state dim over model.

    kv caches  [R, B, S, Hkv, hd] -> P(None, dp, "model", None, None) (S-sharded:
    the sequence axis is the only one guaranteed divisible at 32k).
    MLA latent [R, B, S, r]       -> S over model.
    RG-LRU / RWKV state           -> feature/head dim over model when divisible.
    """
    mesh = as_spec(mesh)
    dp = dp_axes(mesh)
    tp = int(mesh.shape.get("model", 1))
    dp_n = int(math.prod(mesh.shape[a] for a in dp))

    def one(name, leaf):
        shape = tuple(leaf.shape)
        nd = len(shape)
        spec: list = [None] * nd
        # batch axis: axis 1 for stage-stacked caches, 0 otherwise
        b_ax = 1 if nd >= 2 else 0
        if _div(shape[b_ax], dp_n):
            spec[b_ax] = _dp_entry(dp)
        if nd >= 4 and ("/k" in name or "/v" in name or "ckv" in name or "kpe" in name):
            if _div(shape[b_ax + 1], tp):
                spec[b_ax + 1] = "model"  # sequence axis
        elif nd >= 3 and ("ckv" in name or "kpe" in name):
            if _div(shape[b_ax + 1], tp):
                spec[b_ax + 1] = "model"
        else:  # recurrent state: shard trailing feature dim when divisible
            if nd >= 2 and _div(shape[-1], tp) and shape[-1] >= 1024:
                spec[-1] = "model"
        return NamedSharding(mesh, P(*spec))

    return tree_map_with_path(one, cache_shape)


def paged_cache_shardings(cache_shape: Any, cfg, mesh, mask):
    """Shardings for a paged pool (``lm.init_paged_cache``).

    Paged leaves ``[R, num_blocks, block_size, ...]`` shard the BLOCKS axis
    over the data axes when divisible; per-lane (unpaged) leaves keep the
    ``cache_shardings`` rules.  ``mask``: ``lm.paged_cache_mask(cfg)``.
    """
    mesh = as_spec(mesh)
    dp = dp_axes(mesh)
    dp_n = int(math.prod(mesh.shape[a] for a in dp))
    contiguous = cache_shardings(cache_shape, cfg, mesh)

    def one(is_paged, leaf, fallback):
        if not is_paged:
            return fallback
        spec: list = [None] * len(leaf.shape)
        if len(leaf.shape) >= 2 and _div(leaf.shape[1], dp_n):
            spec[1] = _dp_entry(dp)
        return NamedSharding(mesh, P(*spec))

    return tree_map(one, mask, cache_shape, contiguous)


# -------------------------------------------------------------------- ST-GNN
def stgnn_param_shardings(params_shape: Any, mesh):
    """DCRNN-family params are tiny (hidden 64) — replicate (the paper's DDP)."""
    return tree_map(lambda _: replicated(mesh), params_shape)


def series_sharding(mesh, *, partitioned: bool) -> NamedSharding:
    """Resident series [T, N, F]: replicated (distributed-index-batching) or
    time-sharded over the data axes (generalized / baseline-DDP)."""
    if not partitioned:
        return replicated(mesh)
    return NamedSharding(as_spec(mesh), P(_dp_entry(dp_axes(mesh))))
