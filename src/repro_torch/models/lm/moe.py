"""Mixture-of-Experts FFN (grok-1: 8e top-2; deepseek-v2-lite: 64e top-6 + 2 shared).

Dispatch is sort-based with static capacity (dropless up to
``capacity_factor``), as in the JAX package: tokens are ordered by expert id
(a stable sort keeps earlier tokens at higher priority), positions within
each expert's queue come from segment starts, and tokens beyond capacity are
dropped (they keep their residual and shared-expert path).  Expert compute
is one batched product per projection, ``[E, C, d] x [E, d, de]``.

Two choices differ from a literal transcription:

- the top-k breaks ties toward the lower expert id explicitly (a stable
  descending sort), which is what ``jax.lax.top_k`` does;
- ``_dispatch_indices`` writes only the kept assignments into the slot
  table.  The JAX version also writes each dropped one's sentinel at slot
  ``(e, 0)``, duplicate indices whose ``.at[].set`` result the backend
  chooses; on the CPU the last write wins and the expert's first kept token
  is lost too.  The port keeps what the code means: FIFO, dropped ->
  sentinel only where nothing was kept.

DeepSeek-V2's routing is a choice of :class:`MoEConfig` (the JAX package
has none of it): top-k weights without renormalisation, times
``routed_scaling_factor``; the balance loss per sequence (``seq_aux``);
and ``dropless`` dispatch (:func:`_moe_ffn_dropless`), in which every
assignment is computed: assignments sorted by expert, each expert's rows
padded to whole tiles of ``TILE`` rows, the tiles' products batched with
each tile's own expert's weights (:class:`_TiledGatedFFN`), and the rows
gathered back to their tokens and weighted.  Its shapes depend only on
the token count, so nothing is read on the host.  With tracing on, the
dropless layer opens ``route`` and ``experts`` (forward and backward);
with counting on (``tracing.count_on``) the single-device layers count
``moe.assignments`` and ``moe.dropped``, the dropless one ``moe.max_load``
too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.distributed import is_dtensor
from repro_torch.models.lm.config import MoEConfig
from repro_torch.models.lm.layers import Draw, gelu, init_linear, init_mlp, mlp
from repro_torch.tracing import count, counting, spanned

#: Rows of a dropless tile: each expert's assignments are padded to whole
#: tiles, and each tile's product takes its expert's weights.
TILE = 256
#: Tiles a batched product takes at once, which bounds the gathered weights
#: (and the backward's per-tile weight gradients) a pass holds.
TILES_PER_PASS = 64


def init_moe(draw: Draw, d_model: int, moe: MoEConfig, d_ff: int, mlp_kind: str,
             dtype=torch.float32, lead: tuple = ()):
    de = moe.d_expert or d_ff
    scale = 1.0 / d_model ** 0.5
    e = moe.n_experts

    def stack(shape):  # scaled in place: one float32 transient per leaf
        return draw(lead + shape).mul_(scale).to(dtype)

    p = {
        # the router stays float32 whatever the parameter dtype, as in JAX
        "router": init_linear(draw, d_model, e, dtype=torch.float32, lead=lead),
        "wi": stack((e, d_model, de)),
        "wg": stack((e, d_model, de)),
        "wo": stack((e, de, d_model)),
    }
    if moe.n_shared:
        p["shared"] = init_mlp(draw, d_model, moe.n_shared * de, mlp_kind,
                               dtype=dtype, lead=lead)
    return p


def capacity_of(tokens: int, moe: MoEConfig) -> int:
    """Slots per expert for ``tokens`` tokens: ``tokens * k / E * cf``,
    rounded up to a multiple of 128 and at least 128."""
    capacity = int(tokens * moe.top_k / moe.n_experts * moe.capacity_factor)
    return max(128, -(-capacity // 128) * 128)


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, in descending
    order, ties broken toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_indices(top_ix: torch.Tensor, n_experts: int, capacity: int):
    """top_ix: [T, k] expert ids -> slot_src [E, C]: the flat (token, slot)
    index ``token * k + slot`` held by each expert's queue position, or the
    sentinel ``T * k`` where the slot is empty.  Integer ops only, no host
    sync: dropped assignments land in a dump column that is cut off."""
    t, k = top_ix.shape
    e_flat = top_ix.reshape(-1)  # token-major: token i slot j -> i*k + j
    order = torch.argsort(e_flat, stable=True)  # grouped by expert, FIFO inside
    sorted_e = e_flat[order]
    # made from the indices (new_zeros / new_full), so a DTensor routing
    # (the dry-run's sharded cells) writes into DTensors
    counts = e_flat.new_zeros(n_experts, dtype=torch.long)
    counts.index_add_(0, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=top_ix.device) - starts[sorted_e]
    col = torch.where(pos < capacity, pos, capacity)  # dropped -> dump column
    slot_src = order.new_full((n_experts, capacity + 1), t * k, dtype=torch.long)
    slot_src[sorted_e, col] = order
    return slot_src[:, :capacity]


def _expert_ffn(p, xe, mlp_kind: str, eq_in: str, eq_out: str):
    """The batched expert FFN over dispatched tokens ``xe``."""
    dt = xe.dtype
    if mlp_kind in ("swiglu", "geglu"):
        act = F.silu if mlp_kind == "swiglu" else gelu
        hi = torch.einsum(eq_in, xe, p["wi"].to(dt))
        hg = torch.einsum(eq_in, xe, p["wg"].to(dt))
        he = act(hg) * hi
    else:
        he = gelu(torch.einsum(eq_in, xe, p["wi"].to(dt)))
    return torch.einsum(eq_out, he, p["wo"].to(dt))


def _router(p, x, moe: MoEConfig):
    """(probs, top_w, top_ix), float32: the softmax over the experts and the
    top-k, whose weights are renormalised to sum to 1 (``norm_topk_prob``)
    and scaled by ``routed_scaling_factor``."""
    probs = torch.softmax(x.float() @ p["router"]["w"].float(), dim=-1)
    top_w, top_ix = _top_k(probs, moe.top_k)
    if moe.norm_topk_prob:
        top_w = top_w / top_w.sum(-1, keepdim=True)
    if moe.routed_scaling_factor != 1.0:
        top_w = top_w * moe.routed_scaling_factor
    return probs, top_w, top_ix


def _balance_loss(moe: MoEConfig, probs, top_ix, batch: int):
    """The load-balancing loss of one layer.  Switch-style (default):
    ``coef * E * sum_e f_e P_e`` over all tokens.  ``seq_aux`` (DeepSeek-V2):
    ``coef * mean_b sum_e f_be P_be`` over each of the ``batch`` sequences,
    ``f_be`` expert e's picks in sequence b over ``S k / E``, ``P_be`` its
    mean probability there."""
    e = moe.n_experts
    if not moe.seq_aux:
        me = probs.mean(0)
        fe = F.one_hot(top_ix, e).float().sum(1).mean(0)
        return moe.aux_loss_coef * e * torch.sum(fe * me)
    seq = probs.shape[0] // batch
    picks = F.one_hot(top_ix.reshape(batch, -1), e).float().sum(1)  # [B, E]
    f = picks / (seq * moe.top_k / e)
    pm = probs.reshape(batch, seq, e).mean(1)
    return moe.aux_loss_coef * torch.sum(f * pm, dim=1).mean()


def moe_ffn(p, x: torch.Tensor, moe: MoEConfig, mlp_kind: str, *, groups: int = 1):
    """x: [B, S, d] -> (y, aux_loss).

    ``groups > 1``: grouped local dispatch (:func:`_moe_ffn_grouped`), each
    group of tokens with its own capacity; the JAX package reaches it only
    through a sharding's ``moe_groups``.
    """
    b, s, d = x.shape
    if moe.dropless:
        if groups > 1 or is_dtensor(x):
            raise NotImplementedError("dropless MoE runs on one device, ungrouped")
        return _moe_ffn_dropless(p, x, moe, mlp_kind)
    if groups > 1:
        return _moe_ffn_grouped(p, x, moe, mlp_kind, groups=groups)
    if is_dtensor(x):
        return _moe_ffn_sharded(p, x, moe, mlp_kind)
    t, k = b * s, moe.top_k
    xf = x.reshape(t, d)
    probs, top_w, top_ix = _router(p, xf, moe)
    slot_src = _dispatch_indices(top_ix, moe.n_experts, capacity_of(t, moe))

    token_of = slot_src // k  # sentinel t*k -> t (out of range)
    valid = slot_src < t * k
    xe = xf[torch.where(valid, token_of, 0)]  # [E, C, d]
    w_slot = torch.where(valid, top_w.reshape(-1)[torch.where(valid, slot_src, 0)], 0.0)
    ye = _expert_ffn(p, xe, mlp_kind, "ecd,edf->ecf", "ecf,efd->ecd")

    # Combine: scatter-add weighted expert outputs back to tokens (+1 dump row).
    contrib = (ye * w_slot[..., None].to(x.dtype)).reshape(-1, d)
    yf = torch.zeros((t + 1, d), dtype=x.dtype, device=x.device).index_add(
        0, torch.where(valid, token_of, t).reshape(-1), contrib)
    y = yf[:t].reshape(b, s, d)
    if moe.n_shared:
        y = y + mlp(p["shared"], x, mlp_kind)
    if counting():
        kept = valid.sum()
        count("moe.assignments", kept)
        count("moe.dropped", t * k - kept)
    return y, _balance_loss(moe, probs, top_ix, b)


def _moe_ffn_sharded(p, x, moe: MoEConfig, mlp_kind: str):
    """:func:`moe_ffn` in a DTensor program (the dry-run's sharded cells).

    Every device routes all the tokens (the dispatch buffers stay
    replicated, as in the JAX package's sharded cells) with the same
    integer dispatch as :func:`moe_ffn`, on local tensors.  The expert
    weights keep their split over experts (EP) and gather any other; each
    device runs its own experts' slots and scatter-adds them into a partial
    output, which one all-reduce over the EP mesh axes completes.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    local = lambda t: t.redistribute(mesh, rep).to_local()
    b, s, d = x.shape
    t, k = b * s, moe.top_k
    xf = local(x).reshape(t, d)
    probs, top_w, top_ix = _router({"router": {n: local(w) for n, w in p["router"].items()}},
                                   xf, moe)
    slot_src = _dispatch_indices(top_ix, moe.n_experts, capacity_of(t, moe))

    ep = [i for i, pl in enumerate(p["wi"].placements) if pl == Shard(0)]
    keep = [Shard(0) if i in ep else Replicate() for i in range(mesh.ndim)]
    pe = {n: p[n].redistribute(mesh, keep).to_local() for n in ("wi", "wg", "wo")}
    n_local = pe["wi"].shape[0]
    coord, shard = mesh.get_coordinate(), 0
    for i in ep:
        shard = shard * mesh.size(i) + coord[i]
    mine = slot_src[shard * n_local:(shard + 1) * n_local]  # [E_local, C]

    token_of = mine // k
    valid = mine < t * k
    xe = xf[torch.where(valid, token_of, 0)]
    w_slot = torch.where(valid, top_w.reshape(-1)[torch.where(valid, mine, 0)], 0.0)
    ye = _expert_ffn(pe, xe, mlp_kind, "ecd,edf->ecf", "ecf,efd->ecd")
    contrib = (ye * w_slot[..., None].to(xf.dtype)).reshape(-1, d)
    yf = torch.zeros((t + 1, d), dtype=xf.dtype, device=xf.device).index_add(
        0, torch.where(valid, token_of, t).reshape(-1), contrib)
    y = DTensor.from_local(yf[:t].reshape(b, s, d), mesh,
                           [Partial() if i in ep else Replicate() for i in range(mesh.ndim)],
                           run_check=False).redistribute(
        mesh, [Replicate() if pl.is_partial() else pl for pl in x.placements])
    if moe.n_shared:
        y = y + mlp(p["shared"], x, mlp_kind)
    aux = _balance_loss(moe, probs, top_ix, b)
    return y, DTensor.from_local(aux, mesh, rep, run_check=False)


def _moe_ffn_grouped(p, x, moe: MoEConfig, mlp_kind: str, *, groups: int):
    """Grouped local dispatch with an explicit leading group dim: every
    dispatch op (sort, position, gather, scatter) runs per group, each group
    with its own capacity."""
    b, s, d = x.shape
    t = b * s
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} groups")
    tg = t // groups
    e, k = moe.n_experts, moe.top_k
    xg = x.reshape(groups, tg, d)
    probs, top_w, top_ix = _router(p, xg, moe)  # [g, tg, E], [g, tg, k]
    capacity = capacity_of(tg, moe)
    slot_src = torch.stack([_dispatch_indices(top_ix[g], e, capacity)
                            for g in range(groups)])  # [g, E, C]

    token_of = slot_src // k
    valid = slot_src < tg * k
    gather_ix = torch.where(valid, token_of, 0).reshape(groups, e * capacity)
    xe = torch.gather(xg, 1, gather_ix[..., None].expand(-1, -1, d))
    xe = xe.reshape(groups, e, capacity, d)
    w_flat = top_w.reshape(groups, tg * k)
    w_slot = torch.where(valid, torch.gather(
        w_flat, 1, torch.where(valid, slot_src, 0).reshape(groups, e * capacity)
    ).reshape(groups, e, capacity), 0.0)
    ye = _expert_ffn(p, xe, mlp_kind, "gecd,edf->gecf", "gecf,efd->gecd")

    scatter_ix = torch.where(valid, token_of, tg).reshape(groups, e * capacity)
    contrib = (ye * w_slot[..., None].to(x.dtype)).reshape(groups, e * capacity, d)
    yf = torch.zeros((groups, tg + 1, d), dtype=x.dtype, device=x.device).scatter_add(
        1, scatter_ix[..., None].expand(-1, -1, d), contrib)
    y = yf[:, :tg].reshape(b, s, d)
    if moe.n_shared:
        y = y + mlp(p["shared"], x, mlp_kind)

    me = probs.mean((0, 1))
    fe = F.one_hot(top_ix, e).float().sum(2).mean((0, 1))
    return y, moe.aux_loss_coef * e * torch.sum(fe * me)


# ------------------------------------------------------------------ dropless
def _tile_layout(top_ix: torch.Tensor, n_experts: int):
    """The dropless layout of the assignments ``top_ix`` [T, k] (token-major
    ids ``a = token * k + slot``), on their device with no host read:

    - ``src`` [tiles * TILE]: the token each padded row takes, ``T`` (a
      zero row) where a tile's tail is empty;
    - ``row`` [T * k]: the padded row of assignment ``a``;
    - ``tile_expert`` [tiles]: each tile's expert;
    - ``counts`` [E]: each expert's assignments.

    Experts' rows follow in expert order, each expert's in token order,
    padded to whole tiles; ``tiles`` is ``ceil(T k / TILE) + E``, the most
    any routing needs, and the tiles past the last expert's hold zero rows.
    """
    t, k = top_ix.shape
    tile = TILE
    e_flat = top_ix.reshape(-1)
    order = torch.argsort(e_flat, stable=True)  # by expert, tokens in order
    counts = e_flat.new_zeros(n_experts).index_add_(0, e_flat, torch.ones_like(e_flat))
    first = torch.cumsum(counts, 0) - counts  # each expert's first sorted position
    tiles = (counts + tile - 1) // tile
    tile_end = torch.cumsum(tiles, 0)
    sorted_e = e_flat[order]
    rank = torch.arange(t * k, device=top_ix.device) - first[sorted_e]
    row = torch.empty_like(order)
    row[order] = (tile_end - tiles)[sorted_e] * tile + rank
    n_tiles = -(-t * k // tile) + n_experts
    src = e_flat.new_full((n_tiles * tile,), t)
    src[row] = torch.arange(t * k, device=top_ix.device) // k
    tile_expert = torch.searchsorted(tile_end, torch.arange(n_tiles, device=top_ix.device),
                                     right=True).clamp_(max=n_experts - 1)
    return src, row, tile_expert, counts


def _gated(kind: str):
    if kind == "swiglu":
        return F.silu
    if kind == "geglu":
        return gelu
    raise NotImplementedError(f"dropless MoE takes a gated expert MLP, not {kind!r}")


def _tile_products(x, w, tile_expert, out, *, transpose: bool = False):
    """``out[tile j] = x[tile j] @ w[expert of j]`` (``w``'s transpose with
    ``transpose``) for x: [tiles, tile, a], w: [E, a, b] ([E, b, a]), a
    batched product over ``TILES_PER_PASS`` tiles at a time."""
    for lo in range(0, tile_expert.numel(), TILES_PER_PASS):
        hi = min(lo + TILES_PER_PASS, tile_expert.numel())
        wj = w[tile_expert[lo:hi]]
        torch.bmm(x[lo:hi], wj.transpose(1, 2) if transpose else wj, out=out[lo:hi])
    return out


def _weight_grads(x, g, tile_expert, like):
    """``sum over tiles j of expert e of x[j]^T @ g[j]`` for every e, shaped
    like ``like`` [E, a, b]; x: [tiles, tile, a], g: [tiles, tile, b]."""
    dw = torch.zeros_like(like, dtype=x.dtype)
    for lo in range(0, tile_expert.numel(), TILES_PER_PASS):
        hi = min(lo + TILES_PER_PASS, tile_expert.numel())
        dw.index_add_(0, tile_expert[lo:hi], torch.bmm(x[lo:hi].transpose(1, 2), g[lo:hi]))
    return dw


class _TiledGatedFFN(torch.autograd.Function):
    """The routed experts' gated MLP over padded tiles,
    ``(act(x Wg) * (x Wi)) Wo`` with each tile's expert's weights.  Saves
    the tiles' input and two projections and recomputes the gate in the
    backward; the weights are gathered a pass of tiles at a time, forward
    and backward, never for all tiles at once."""

    @staticmethod
    def forward(ctx, xs, wi, wg, wo, tile_expert, kind):
        n = tile_expert.numel()
        x = xs.reshape(n, -1, xs.shape[-1])
        de = wi.shape[-1]
        hi = _tile_products(x, wi.to(xs.dtype), tile_expert, x.new_empty(n, x.shape[1], de))
        hg = _tile_products(x, wg.to(xs.dtype), tile_expert, x.new_empty(n, x.shape[1], de))
        a = _gated(kind)(hg) * hi
        ys = _tile_products(a, wo.to(xs.dtype), tile_expert, x.new_empty(x.shape))
        ctx.save_for_backward(xs, hi, hg, wi, wg, wo, tile_expert)
        ctx.kind = kind
        return ys.reshape(xs.shape)

    @staticmethod
    def backward(ctx, dys):
        xs, hi, hg, wi, wg, wo, tile_expert = ctx.saved_tensors
        n = tile_expert.numel()
        x = xs.reshape(n, -1, xs.shape[-1])
        dy = dys.reshape(x.shape)
        with torch.enable_grad():
            hi_, hg_ = hi.detach().requires_grad_(True), hg.detach().requires_grad_(True)
            a = _gated(ctx.kind)(hg_) * hi_
        da = _tile_products(dy, wo.to(dy.dtype), tile_expert, torch.empty_like(hi),
                            transpose=True)
        dwo = _weight_grads(a.detach(), dy, tile_expert, wo)
        dhi, dhg = torch.autograd.grad(a, (hi_, hg_), da)
        del a, da, hi_, hg_
        dx = _tile_products(dhi, wi.to(dy.dtype), tile_expert, torch.empty_like(x),
                            transpose=True)
        dx += _tile_products(dhg, wg.to(dy.dtype), tile_expert, torch.empty_like(x),
                             transpose=True)
        dwi = _weight_grads(x, dhi, tile_expert, wi)
        dwg = _weight_grads(x, dhg, tile_expert, wg)
        return (dx.reshape(xs.shape), dwi.to(wi.dtype), dwg.to(wg.dtype), dwo.to(wo.dtype),
                None, None)


def _moe_ffn_dropless(p, x, moe: MoEConfig, mlp_kind: str):
    """:func:`moe_ffn` with every assignment computed (see the module
    docstring).  The regions ``route`` (router, top-k, sort, dispatch; then
    the weighted combine) and ``experts`` (routed and shared products) are
    spans forward and backward (``tracing.spanned``)."""
    b, s, d = x.shape
    t, k, e = b * s, moe.top_k, moe.n_experts
    xf = x.reshape(t, d)

    def dispatch(xf):
        probs, top_w, top_ix = _router(p, xf, moe)
        src, row, tile_expert, counts = _tile_layout(top_ix, e)
        xs = torch.cat([xf, xf.new_zeros((1, d))])[src]
        if counting():
            placed = counts.sum()
            count("moe.assignments", placed)
            count("moe.dropped", t * k - placed)
            count("moe.max_load", counts.max())
        return _balance_loss(moe, probs, top_ix, b), top_w, xs, row, tile_expert

    def experts(xs, xf):
        ys = _TiledGatedFFN.apply(xs, p["wi"], p["wg"], p["wo"], tile_expert, mlp_kind)
        return (ys, mlp(p["shared"], xf, mlp_kind)) if moe.n_shared else (ys,)

    def combine(top_w, ys, *shared):
        y = torch.sum(ys[row].reshape(t, k, d) * top_w[..., None].to(ys.dtype), dim=1)
        return y + shared[0] if shared else y

    aux, top_w, xs, row, tile_expert = spanned("route", dispatch, xf)
    y = spanned("route", combine, top_w, *spanned("experts", experts, xs, xf))
    return y.reshape(b, s, d), aux
