"""Step builders and shape specs for every (arch × shape) cell.

``build_cell(arch_id, shape_name, mesh, ...)`` returns a ``CellProgram``: the
step function, its args as :class:`TensorSpec` trees (shape and dtype, no
storage) and the in/out shardings — what ``dryrun.py`` needs to run one step
under ``FakeTensorMode`` on a fake process group, and what a caller needs to
run it for real (:func:`place_args`).

The step functions are DTensor programs: every argument arrives as a
``DTensor`` placed by its sharding, and torch's sharding propagation inserts
the collectives that XLA's partitioner inserts for the JAX package.  Plain
tensors that the models make inside (``arange`` grids, masks, zeros) are
taken as replicated (``implicit_replication``).

The paper's technique is baked into the train steps: the program takes the
RESIDENT series/stream plus int32 window starts and reconstructs the batch
on the device (index-batching).  ``placement`` selects the paper's three
distributed designs: replicated (distributed-index-batching), partitioned
(generalized-…, local windows), ondemand (baseline DDP: partitioned series,
global windows → data collectives).

Parameter and cache shapes come from the models' own ``init`` functions run
under ``FakeTensorMode``: nothing is drawn or allocated.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.batching import gather_batch_fused, lm_window_batch
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import as_spec, dp_axes, dp_size, mesh_chips
from repro_torch.loops import trips
from repro_torch.models import dcrnn, pgt_dcrnn
from repro_torch.models.lm import model as lm
from repro_torch.optim.adam import AdamConfig, apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

# Dry-run token-stream length (resident series for LM index-batching).
STREAM_LEN = 1 << 22  # 4M tokens, 16 MiB int32 — replicated everywhere


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one argument leaf (``jax.ShapeDtypeStruct``)."""

    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return int(math.prod(self.shape)) * self.dtype.itemsize


@dataclasses.dataclass
class CellProgram:
    name: str
    kind: str  # train | prefill | decode
    fn: Callable
    args: tuple  # TensorSpec trees
    in_shardings: tuple
    out_shardings: Any
    meta: dict
    # exclusive upper bound of the integer draws :func:`place_args` makes
    # for each top-level arg (window starts must stay inside the series,
    # tokens inside the vocabulary, lengths inside the cache)
    int_high: tuple = ()


def _sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(s) for s in shape), dtype)


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _shapes(build: Callable[[], Any]) -> Any:
    """The tree ``build()`` returns, as :class:`TensorSpec` leaves: it runs
    under ``FakeTensorMode``, so a 300 B-parameter init allocates nothing."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = build()
    return tree_map(lambda t: _sds(t.shape, t.dtype), tree)


def _adam_for(arch) -> AdamConfig:
    # bf16 optimizer state for the very large archs (grok)
    state_dtype = ("bfloat16" if arch.lm is not None and arch.lm.param_count() > 1e11
                   else "float32")
    return AdamConfig(lr=3e-4, weight_decay=0.1, state_dtype=state_dtype)


def _opt_shapes(params_shape, adam: AdamConfig):
    dt = _dtype(adam.state_dtype)
    like = lambda p: _sds(p.shape, dt)
    return {"m": tree_map(like, params_shape), "v": tree_map(like, params_shape),
            "step": _sds((), torch.int32)}


def _program():
    """Context of every step: plain tensors made inside are replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def _rows_local(fn: Callable, src, starts, **kw):
    """``fn(src, starts, **kw)``: tensors whose dim 0 follows ``starts``.

    With a replicated DTensor ``src`` (the series or token stream every
    device holds) and DTensor ``starts``, each device gathers its own
    windows from its own copy, and the outputs are placed as ``starts``
    are: index-batching's local gather, with no collective.
    """
    from torch.distributed.tensor import DTensor, Replicate

    if not (isinstance(src, DTensor) and isinstance(starts, DTensor)) or any(
            p != Replicate() for p in src.placements):
        return fn(src, starts, **kw)
    outs = fn(src.to_local(), starts.to_local(), **kw)
    wrap = lambda t: DTensor.from_local(
        t, starts.device_mesh, starts.placements, run_check=False,
        shape=torch.Size((starts.shape[0],) + tuple(t.shape[1:])),
        stride=torch.empty((starts.shape[0],) + tuple(t.shape[1:]), device="meta").stride())
    return tuple(wrap(t) for t in outs)


def _value_and_grad(loss: Callable, params):
    """``(loss(params), d loss / d params)`` with ``params`` as leaves."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        out = loss(p)
        grads = torch.autograd.grad(out, tree_leaves(p))
    return out.detach(), tree_unflatten(p, list(grads))


# ---------------------------------------------------------------------- LM
def _lm_params_shape(cfg):
    return _shapes(lambda: lm.init(torch.Generator(), cfg, device="cpu"))


def act_hints(cfg, mesh, *, seq_shard: bool = False,
              batch_all_axes: bool = False, batch_sharded: bool = True) -> dict:
    """Activation-sharding hints for the LM stack on this mesh.

    act:    [B, S, d]     batch over dp (+ optionally sequence over model: SP)
    logits: [B, S, V]     batch over dp, vocab over model (when divisible)
    tokens: [B, S]        batch over dp
    kv/ckv: written cache rows — batch over dp, SEQUENCE over model, matching
            the resident cache so the prefill write is a local slice
    """
    mesh = as_spec(mesh)
    dp = tuple(mesh.axis_names) if batch_all_axes else dp_axes(mesh)
    tp = 1 if batch_all_axes else int(mesh.shape.get("model", 1))
    seq_ax = "model" if seq_shard and not batch_all_axes else None
    vocab_ax = "model" if tp > 1 and cfg.padded_vocab % tp == 0 else None
    cache_seq_ax = "model" if tp > 1 else None
    ns = lambda *spec: shd.NamedSharding(mesh, shd.P(*spec))
    return {
        "act": ns(dp, seq_ax, None),
        "logits": ns(dp, None, vocab_ax),
        "tokens": ns(dp, None),
        "kv": ns(dp, cache_seq_ax, None, None),
        "ckv": ns(dp, cache_seq_ax, None),
        "qkv": ns(dp, seq_ax, None, None),
        # the q and k/v projections [B, S, heads·hd] before the head split:
        # heads over model only when the head count divides it, and for q
        # the kv head count too, since q splits into [kv heads, group] (the
        # port's own pins: a DTensor view cannot split an unevenly sharded
        # dim)
        "q": ns(dp if batch_sharded else None, seq_ax, "model" if tp > 1
                and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0 else None),
        "kvh": ns(dp if batch_sharded else None, seq_ax,
                  "model" if tp > 1 and cfg.n_kv_heads % tp == 0 else None),
        # MoE dispatch [E, C, d]: left replicated across model, as the JAX
        # package's baseline leaves it
        "moe_cap": None,
    }


def _serve_params_shape(cfg):
    """Inference weights are served in bf16 (f32 master copies live with the
    trainer, not the server)."""
    return tree_map(
        lambda s: _sds(s.shape, torch.bfloat16 if s.dtype == torch.float32 else s.dtype),
        _lm_params_shape(cfg))


def build_lm_train(arch, cell, mesh, *, remat: bool = True,
                   fsdp: tuple[str, ...] = ("data",),
                   microbatches: int | None = None, mode2d: bool = False,
                   q_chunk: int | None = None,
                   kv_chunk: int | None = None) -> CellProgram:
    """``mode2d``: ZeRO-3/2D scheme — no TP, batch sharded over EVERY mesh
    axis, params fully FSDP-sharded across all axes."""
    mesh = as_spec(mesh)
    cfg = arch.lm
    if q_chunk or kv_chunk:
        cfg = dataclasses.replace(cfg, q_chunk=q_chunk or cfg.q_chunk,
                                  kv_chunk=kv_chunk or cfg.kv_chunk)
    adam = _adam_for(arch)
    seq, gb = cell.seq_len, cell.global_batch
    workers = mesh_chips(mesh) if mode2d else dp_size(mesh)
    if microbatches is None:
        # one sequence row per device per microbatch
        microbatches = max(gb // workers, 1)
    big = cfg.param_count() > 1e11
    # >100B params: bf16 gradient accumulation, and FSDP over the pod axis
    grad_dtype = torch.bfloat16 if big else torch.float32
    if big and "pod" in mesh.axis_names and "pod" not in fsdp:
        fsdp = ("pod",) + tuple(fsdp)
    if mode2d:
        fsdp = tuple(mesh.axis_names)
    params_shape = _lm_params_shape(cfg)
    state_shape = {"params": params_shape, "opt": _opt_shapes(params_shape, adam)}
    param_sh = shd.lm_param_shardings(params_shape, cfg, mesh, fsdp=fsdp,
                                      tp_rules=not mode2d)
    state_sh = shd.state_shardings(param_sh, mesh)

    n_prefix = cfg.n_prefix if cfg.frontend == "patches" else 0
    text_len = seq - n_prefix
    hints = act_hints(cfg, mesh, batch_all_axes=mode2d)

    def mb_loss(stream, st, pe):
        def loss(p):
            toks, labels = _rows_local(lm_window_batch, stream, st, seq_len=text_len)
            # anchor activation sharding: batch over the data axes
            toks = shd.constrain(toks, hints["tokens"])
            labels = shd.constrain(labels, hints["tokens"])
            return lm.loss_fn(p, cfg, toks, labels, prefix_embeds=pe,
                              remat=remat, shardings=hints)[0]
        return loss

    def step(state, stream, starts, prefix_embeds=None):
        with _program():
            params = state["params"]
            if microbatches > 1:
                # the starts are gb int32s: replicate them before the split
                # into microbatches (DTensor reshapes no split dim)
                st_all = shd.constrain(starts, shd.replicated(mesh)).reshape(microbatches, -1)
                # as are the patch embeddings (a split dim cannot be
                # reshaped into microbatches): an all-gather of [gb, P, d]
                pe_all = None if prefix_embeds is None else shd.constrain(
                    prefix_embeds, shd.replicated(mesh)).reshape(
                        (microbatches, -1) + tuple(prefix_embeds.shape[1:]))
                l = torch.zeros((), dtype=torch.float32, device=starts.device)
                grads = tree_map(lambda p: torch.zeros_like(p, dtype=grad_dtype), params)
                for i in trips(microbatches, holds_autograd=True):
                    pe = None if pe_all is None else pe_all[i]
                    l_i, g = _value_and_grad(mb_loss(stream, st_all[i], pe), params)
                    l = l + l_i
                    grads = tree_map(lambda a, b: a + b.to(grad_dtype), grads, g)
                l = l / microbatches
                grads = tree_map(lambda g: g / microbatches, grads)
            else:
                l, grads = _value_and_grad(mb_loss(stream, starts, prefix_embeds),
                                           params)
            new_p, new_opt, _ = apply_updates(params, grads, state["opt"], adam,
                                              adam.lr)
        return {"params": new_p, "opt": new_opt}, l

    args = [state_shape, _sds((STREAM_LEN,), torch.int32), _sds((gb,), torch.int32)]
    in_sh = [state_sh, shd.replicated(mesh), shd.batch_sharding(mesh)]
    int_high = [0, cfg.vocab, STREAM_LEN - seq]
    if n_prefix:
        args.append(_sds((gb, n_prefix, cfg.d_model), _dtype(cfg.dtype)))
        in_sh.append(shd.NamedSharding(mesh, shd.P(dp_axes(mesh))))
        int_high.append(0)
    out_sh = (state_sh, shd.replicated(mesh))

    return CellProgram(
        name=f"{arch.id}:{cell.name}", kind="train", fn=step,
        args=tuple(args), in_shardings=tuple(in_sh), out_shardings=out_sh,
        meta={"tokens_per_step": gb * seq, "seq": seq, "batch": gb,
              "params": cfg.param_count(), "active_params": cfg.active_param_count(),
              "microbatches": microbatches},
        int_high=tuple(int_high),
    )


def _cache_shape(cfg, batch: int, max_len: int):
    return _shapes(lambda: lm.init_cache(cfg, batch, max_len, device="cpu"))


def build_lm_prefill(arch, cell, mesh, *, moe_groups: int = 1) -> CellProgram:
    mesh = as_spec(mesh)
    cfg = arch.lm
    seq, gb = cell.seq_len, cell.global_batch
    params_shape = _serve_params_shape(cfg)
    param_sh = shd.lm_param_shardings(params_shape, cfg, mesh, fsdp=())
    cache_shape = _cache_shape(cfg, gb, seq)
    cache_sh = shd.cache_shardings(cache_shape, cfg, mesh)
    hints = act_hints(cfg, mesh)
    if moe_groups > 1:
        dp = dp_axes(mesh)
        hints = {**hints, "moe_groups": moe_groups,
                 "moe_group": shd.NamedSharding(mesh, shd.P(dp, None, None)),
                 "moe_disp": shd.NamedSharding(mesh, shd.P(dp, None, None, None))}

    def step(params, tokens, cache):
        with _program(), torch.no_grad():
            return lm.prefill(params, cfg, tokens, cache, shardings=hints)

    return CellProgram(
        name=f"{arch.id}:{cell.name}", kind="prefill", fn=step,
        args=(params_shape, _sds((gb, seq), torch.int32), cache_shape),
        in_shardings=(param_sh, shd.batch_sharding(mesh), cache_sh),
        out_shardings=(shd.NamedSharding(mesh, shd.P(dp_axes(mesh))), cache_sh,
                       shd.batch_sharding(mesh)),
        meta={"tokens_per_step": gb * seq, "seq": seq, "batch": gb,
              "params": cfg.param_count(), "active_params": cfg.active_param_count(),
              "donate": (2,)},  # the cache is written in place
        int_high=(0, cfg.vocab, 0),
    )


def build_lm_decode(arch, cell, mesh) -> CellProgram:
    mesh = as_spec(mesh)
    cfg = arch.lm
    seq, gb = cell.seq_len, cell.global_batch
    params_shape = _serve_params_shape(cfg)
    param_sh = shd.lm_param_shardings(params_shape, cfg, mesh, fsdp=())
    cache_shape = _cache_shape(cfg, gb, seq)
    cache_sh = shd.cache_shardings(cache_shape, cfg, mesh)
    b_sh = shd.batch_sharding(mesh) if gb > 1 else shd.replicated(mesh)
    hints = act_hints(cfg, mesh, batch_sharded=gb > 1)
    if gb == 1:  # long_500k: nothing to shard the batch over
        hints = {**hints, "act": None, "tokens": None, "logits": hints["logits"]}

    def step(params, token, cache, lengths):
        with _program(), torch.no_grad():
            return lm.decode_step(params, cfg, token, cache, lengths, shardings=hints)

    return CellProgram(
        name=f"{arch.id}:{cell.name}", kind="decode", fn=step,
        args=(params_shape, _sds((gb, 1), torch.int32), cache_shape,
              _sds((gb,), torch.int32)),
        in_shardings=(param_sh, b_sh, cache_sh, b_sh),
        out_shardings=(b_sh, cache_sh),
        meta={"tokens_per_step": gb, "seq": seq, "batch": gb,
              "params": cfg.param_count(), "active_params": cfg.active_param_count(),
              "donate": (2,)},  # the cache is written in place
        int_high=(0, cfg.vocab, 0, seq - 1),
    )


# -------------------------------------------------------------------- ST-GNN
def build_stgnn_train(arch, cell, mesh, *, placement: str = "replicated",
                      use_pallas: bool = False, compute_dtype: str | None = None,
                      series_len: int = 105_120) -> CellProgram:
    """DCRNN / PGT-DCRNN training cell.

    placement: replicated   — distributed-index-batching (paper §4.2): every
               device holds the series; window gathers are local by
               construction; only the gradient all-reduce crosses devices.
               partitioned  — generalized-distributed-index-batching (§5.4):
               series time-sharded over dp; the step is the per-rank local
               program (the JAX package's ``shard_map``): windows gathered
               with SHARD-LOCAL starts, then an explicit gradient all-reduce
               — its only collective.
               ondemand     — baseline DDP: series time-sharded but windows
               sampled globally — the gather from the sharded series
               all-gathers it (the paper's Fig-7 communication wall).
    use_pallas: the gather and the model's hops through the hand-written
               kernels; off, as in the JAX package's cells, the plain path
               (the dry-run traces on meta shards, which no kernel takes).
    """
    mesh = as_spec(mesh)
    if placement not in ("replicated", "partitioned", "ondemand"):
        raise ValueError(f"placement {placement!r}")
    mcfg = dataclasses.replace(arch.model, remat=True, use_pallas=use_pallas)
    adam = AdamConfig(lr=1e-2)
    gb = cell.global_batch
    n, f = mcfg.num_nodes, mcfg.in_features
    in_len, hor = mcfg.input_len, mcfg.horizon
    mod = dcrnn if isinstance(mcfg, dcrnn.DCRNNConfig) else pgt_dcrnn

    params_shape = _shapes(lambda: mod.init(torch.Generator(), mcfg, device="cpu"))
    param_sh = shd.stgnn_param_shardings(params_shape, mesh)
    state_shape = {"params": params_shape, "opt": _opt_shapes(params_shape, adam)}
    state_sh = shd.state_shardings(param_sh, mesh)
    series_sh = shd.series_sharding(mesh, partitioned=placement != "replicated")
    # the paper's DDP: every device is one worker — batch shards over ALL axes
    batch_sh = shd.batch_sharding(mesh, pure_dp=True)
    cdt = _dtype(compute_dtype) if compute_dtype else None

    def loss_of(series, starts, supports):
        def loss(p):
            src = series
            if placement == "ondemand":
                # global starts reach every shard: the gather reads from the
                # all-gathered series (the JAX partitioner's lowering)
                src = shd.constrain(series, shd.replicated(mesh))
            x, y = _rows_local(gather_batch_fused, src, starts, input_len=in_len,
                               horizon=hor, use_pallas=use_pallas)
            if placement != "partitioned":
                x = shd.constrain(x, batch_sh)
            if cdt is not None:
                x = x.to(cdt)
                p = tree_map(lambda w: w.to(cdt), p)
            return mod.loss_fn(p, mcfg, supports, x, y)
        return loss

    def step(state, series, starts, supports):
        with _program():
            l, grads = _value_and_grad(loss_of(series, starts, supports),
                                       state["params"])
            # DDP: one all-reduce of each gradient over every worker
            grads = tree_map(_all_reduce_partial, grads)
            new_p, new_opt, _ = apply_updates(state["params"], grads, state["opt"],
                                              adam, adam.lr)
        return {"params": new_p, "opt": new_opt}, l

    if placement == "partitioned":
        step = _stgnn_partitioned_step(loss_of, adam)

    # bf16 supports enter the program already cast
    sup_dt = cdt or torch.float32
    return CellProgram(
        name=f"{arch.id}:{cell.name}:{placement}", kind="train", fn=step,
        args=(state_shape, _sds((series_len, n, f), torch.float32),
              _sds((gb,), torch.int32), [_sds((n, n), sup_dt), _sds((n, n), sup_dt)]),
        in_shardings=(state_sh, series_sh, batch_sh,
                      [shd.replicated(mesh), shd.replicated(mesh)]),
        out_shardings=(state_sh, shd.replicated(mesh)),
        meta={"windows_per_step": gb, "nodes": n, "placement": placement,
              "series_len": series_len,
              "flops_model": stgnn_model_flops(mcfg, gb)},
        # partitioned starts are shard-local offsets
        int_high=(0, 0, (series_len // dp_size(mesh) if placement == "partitioned"
                         else series_len) - in_len - hor + 1, 0),
    )


def _all_reduce_partial(g):
    """A gradient DTensor made whole: a partial sum over every mesh axis of
    more than one slot (pure data parallelism) is reduced by ONE all-reduce
    over the whole mesh, as XLA reduces the JAX gradient (DTensor's own
    redistribute would reduce one mesh axis after the other); any other
    layout goes through ``redistribute``."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = g.device_mesh
    pl = g.placements
    rep = [Replicate()] * mesh.ndim
    if all(isinstance(p, Replicate) for p in pl):
        return g
    ops = {p.reduce_op for p in pl if isinstance(p, Partial)}
    whole = all(isinstance(p, Partial) or mesh.size(i) == 1 for i, p in enumerate(pl))
    if not whole or len(ops) != 1 or mesh.size() != dist.get_world_size():
        return g.redistribute(mesh, rep)
    local = funcol.all_reduce(g.to_local(), ops.pop(), dist.group.WORLD)
    return DTensor.from_local(local, mesh, rep, run_check=False)


def _stgnn_partitioned_step(loss_of, adam: AdamConfig):
    """The per-rank program of the generalized variant (JAX: ``shard_map``).

    Each rank gathers its windows from its own series shard with its
    shard-local starts and computes gradients; the only collective is the
    explicit gradient (and loss) all-reduce over every device, averaged.
    """
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate

    def step(state, series, starts, supports):
        mesh = series.device_mesh
        world = dist.get_world_size()
        local = lambda t: t.to_local()
        params = tree_map(local, state["params"])
        opt = tree_map(local, state["opt"])
        l, grads = _value_and_grad(
            loss_of(series.to_local(), starts.to_local(), tree_map(local, supports)),
            params)
        # the paper's ONLY collective: average gradients across workers
        mean = lambda t: funcol.all_reduce(t, "sum", dist.group.WORLD) / world
        grads = tree_map(mean, grads)
        l = mean(l)
        new_p, new_opt, _ = apply_updates(params, grads, opt, adam, adam.lr)
        rep = lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                           run_check=False)
        return {"params": tree_map(rep, new_p), "opt": tree_map(rep, new_opt)}, rep(l)

    return step


def stgnn_model_flops(mcfg, batch: int) -> float:
    """Analytic useful FLOPs per train step (fwd+bwd ≈ 3× fwd matmul FLOPs).

    Per diffusion-conv: K hops × 2 supports of [N,N]@[N,B·C] plus the
    [B·N, (1+2K)·C] @ [(1+2K)·C, H] projection.
    """
    n = mcfg.num_nodes
    k = mcfg.max_diffusion_step
    h = mcfg.hidden
    f = mcfg.in_features
    layers = getattr(mcfg, "layers", 1)  # PGT variant is single-layer
    t = mcfg.input_len + (mcfg.horizon if hasattr(mcfg, "layers") else 0)
    c_in = f + h  # gate input width
    n_mat = 1 + 2 * k
    per_dconv = 2 * k * 2 * n * n * batch * c_in + 2 * batch * n * n_mat * c_in * h
    # DCGRU cell: ru (2h out) + c (h out) ≈ 2 dconvs with different out widths
    per_cell = per_dconv * 2
    return 3.0 * per_cell * layers * t


# ------------------------------------------------------------------ registry
def build_cell(arch_id: str, shape_name: str, mesh, **kw) -> CellProgram:
    arch = get_arch(arch_id)
    cell = next((s for s in arch.shapes if s.name == shape_name), None)
    if cell is None:
        raise KeyError(f"{arch_id} has no shape {shape_name!r}")
    if shape_name in arch.skips:
        raise ValueError(f"{arch_id}:{shape_name} skipped — {arch.skips[shape_name]}")
    if arch.family == "stgnn":
        return build_stgnn_train(arch, cell, mesh, **kw)
    if cell.kind == "train":
        return build_lm_train(arch, cell, mesh, **kw)
    if cell.kind == "prefill":
        return build_lm_prefill(arch, cell, mesh, **kw)
    return build_lm_decode(arch, cell, mesh, **kw)


def all_cells():
    """Yield (arch_id, shape_name, skip_reason | None) over the full matrix."""
    from repro_torch.configs import ARCHS

    for aid, arch in ARCHS.items():
        for s in arch.shapes:
            yield aid, s.name, arch.skips.get(s.name)


# ------------------------------------------------------------ placing args
def local_shape(shape: tuple, spec, mesh) -> tuple:
    """Shape of one device's shard of ``shape`` under ``spec`` (every
    sharded dim must divide, as the rules only shard those)."""
    sizes = as_spec(mesh).shape
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        k = int(math.prod(sizes[a] for a in axes))
        if out[d] % k:
            raise ValueError(f"dim {d} of {shape} does not split over {axes} ({k})")
        out[d] //= k
    return tuple(out)


def _leaf_pairs(args, shardings) -> list:
    return list(zip(tree_leaves(list(args)), tree_leaves(list(shardings))))


def place_args(prog: CellProgram, device_mesh, make_local: Callable) -> tuple:
    """The program's args as DTensors on ``device_mesh``.

    ``make_local(spec, local_shape, index, int_high, path)`` makes this
    rank's shard of the leaf: ``index`` is its position in the args'
    flattening order (JAX's), ``int_high`` the top-level arg's integer
    bound, ``path`` ``"<arg>/<leaf path>"`` (``"0/opt/m/ru/w"``).
    """
    from torch.distributed.tensor import DTensor

    placed = []
    k = 0
    for i, (arg, sh, high) in enumerate(zip(prog.args, prog.in_shardings,
                                            prog.int_high or (0,) * len(prog.args))):
        leaves = []
        for path, spec, s in zip(tree_paths(arg), tree_leaves(arg), tree_leaves(sh)):
            local = make_local(spec, local_shape(spec.shape, s.spec, s.mesh), k, high,
                               f"{i}/{path}".rstrip("/"))
            k += 1
            stride = torch.empty(spec.shape, device="meta").stride()
            leaves.append(DTensor.from_local(local, device_mesh, s.placements(device_mesh),
                                             run_check=False, shape=torch.Size(spec.shape),
                                             stride=stride))
        placed.append(tree_unflatten(arg, leaves))
    return tuple(placed)


def _fresh(path: str) -> bool:
    """An optimizer leaf (moments, step): a real first step starts them at 0."""
    return path.startswith("0/opt/")


def empty_local(device) -> Callable:
    """``make_local`` for :func:`place_args`: uninitialised shards (the
    dry-run makes them on the meta device)."""
    def make(spec, shape, index, high, path):
        return torch.empty(shape, dtype=spec.dtype, device=device)
    return make


def random_local(device, seed: int = 0) -> Callable:
    """``make_local`` for :func:`place_args` at one rank on a card: drawn
    on the device from a seeded generator, straight into each leaf's dtype
    (normals × 0.1, integers in ``[0, int_high)``, zeros where the bound is
    0 and for the optimizer state, fresh as at a first step), so placing the
    args allocates the args and nothing else."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def make(spec, shape, index, high, path):
        if _fresh(path):
            return torch.zeros(shape, dtype=spec.dtype, device=device)
        if spec.dtype.is_floating_point:
            t = torch.randn(shape, generator=gen, dtype=spec.dtype, device=device)
            return t.mul_(0.1)
        if high:
            return torch.randint(0, high, shape, generator=gen, dtype=spec.dtype,
                                 device=device)
        return torch.zeros(shape, dtype=spec.dtype, device=device)
    return make


def seeded_local(device, seed: int = 0) -> Callable:
    """``make_local`` for :func:`place_args` at one rank: seeded numpy draws,
    normals × 0.1 for floats and integers in ``[0, int_high)`` (zeros where
    the bound is 0 and for the optimizer state)."""
    def make(spec, shape, index, high, path):
        rng = np.random.default_rng([seed, index])
        if _fresh(path):
            return torch.zeros(shape, dtype=spec.dtype, device=device)
        if spec.dtype.is_floating_point:
            a = (rng.standard_normal(shape) * 0.1).astype(np.float32)
            return torch.from_numpy(a).to(device=device, dtype=spec.dtype)
        a = rng.integers(0, high, size=shape) if high else np.zeros(shape)
        return torch.from_numpy(a.astype(np.int64)).to(device=device, dtype=spec.dtype)
    return make

