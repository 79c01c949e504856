"""LM backbone assembly: stage-planned block stacks.

Layers are grouped into *stages*, maximal runs of a repeating block pattern,
and each stage's parameters stack over a leading ``repeats`` dim, exactly as
the JAX package lays them out; its ``lax.scan`` over repeats is a Python
loop here that indexes the stacked parameters and caches.

Block spec = (mixer, ffn):
    mixer ∈ full | swa | mla | rec | rwkv      ffn ∈ dense | moe | rwkv
Examples: grok = ("full","moe")×64; deepseek = ("mla","dense") + ("mla","moe")×26;
recurrentgemma = [("rec","dense"),("rec","dense"),("swa","dense")]×8 + 2 rec.

Paged caches (``init_paged_cache``) turn the seq-dim leaves (full-attention
k/v, MLA latents) into per-layer pools of fixed-size blocks shared by every
lane through per-lane block tables; ``decode_step(..., paged=...)`` writes
and reads them through the tables.

Caches are updated in place: where the JAX functions return a new cache
pytree, these write the one they are given (it is also returned), so a
decode step allocates no second copy of the pool.  Train mode (``forward``,
``backbone``) has no cache and writes nothing in place, so autograd runs
through it; ``loss_fn`` trains the LM archs and ST-LLM trains its node
tokens through ``backbone``.

``shardings`` (every public function): the launcher's activation hints
(``launch/specs.act_hints``), for the dry-run's DTensor programs.  Each hint
redistributes a DTensor activation to its placements, as the JAX package's
``with_sharding_constraint`` pins; plain tensors pass through, and without
hints nothing changes.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import (as_dtensor, constrain, is_dtensor, local_offset,
                                          minor_split)
from repro_torch.device import resolve_device
from repro_torch.models.lm import rglru, rwkv6
from repro_torch.models.lm.attention import (
    NEG_INF,
    banded_attention,
    blockwise_attention,
    decode_attention,
    full_attention,
    paged_tables,
    paged_view,
    paged_write,
    roll_seq,
    write_prefix,
    write_token,
    zero_pad,
)
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import (apply_rope, init_linear, init_mlp,
                                          linear, mlp, rms_norm)
from repro_torch.models.lm.mla import init_mla, mla_attention, mla_decode
from repro_torch.models.lm.moe import init_moe, moe_ffn
from repro_torch.tracing import spanned
from repro_torch.tree import tree_map

BLOCKWISE_THRESHOLD = 2048  # switch to flash-style attention above this seq len

#: leaves the layers read in float32 whatever the compute dtype (RG-LRU's
#: ``lam``, the MoE router, RWKV's ``w0`` and ``u``); ``compute_copy``
#: leaves them as they are
_F32_LEAVES = ("lam", "router", "w0", "u")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _constrain(x, shardings, key):
    """``x`` redistributed to the hint ``shardings[key]`` when it is a
    DTensor (``core.distributed.constrain``); no hints: ``x``."""
    if shardings is None:
        return x
    return constrain(x, shardings.get(key))


# ------------------------------------------------------------------ stage plan
@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # full | swa | mla | rec | rwkv
    ffn: str  # dense | moe | rwkv


def layer_specs(cfg: LMConfig) -> list[LayerSpec]:
    specs = []
    for i, kind in enumerate(cfg.block_types()):
        if kind == "rwkv":
            specs.append(LayerSpec("rwkv", "rwkv"))
            continue
        mixer = {"attn": "full"}.get(kind, kind)
        if cfg.moe is not None and i >= cfg.moe.first_k_dense:
            ffn = "moe"
        else:
            ffn = "dense"
        specs.append(LayerSpec(mixer, ffn))
    return specs


def stage_plan(cfg: LMConfig) -> list[tuple[tuple[LayerSpec, ...], int]]:
    """[(super-layer spec tuple, repeats), ...] covering all layers in order."""
    specs = layer_specs(cfg)
    if cfg.block_pattern is not None:
        period = len(cfg.block_pattern)
        n_full, rem = divmod(len(specs), period)
        plan = [(tuple(specs[:period]), n_full)]
        if rem:
            plan.append((tuple(specs[n_full * period:]), 1))
        return plan
    # group maximal runs of identical specs
    plan = []
    for spec, grp in itertools.groupby(specs):
        plan.append(((spec,), len(list(grp))))
    return plan


# ----------------------------------------------------------------------- init
def _init_attn(draw, cfg: LMConfig, dtype, lead):
    hd = cfg.hd
    return {
        "wq": init_linear(draw, cfg.d_model, cfg.n_heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, lead=lead),
        "wk": init_linear(draw, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, lead=lead),
        "wv": init_linear(draw, cfg.d_model, cfg.n_kv_heads * hd, bias=cfg.qkv_bias,
                          dtype=dtype, lead=lead),
        "wo": init_linear(draw, cfg.n_heads * hd, cfg.d_model, dtype=dtype, lead=lead),
    }


def _init_layer(draw, cfg: LMConfig, spec: LayerSpec, dtype, lead, device):
    ones = torch.ones(lead + (cfg.d_model,), dtype=dtype, device=device)
    p: dict[str, Any] = {"norm1": ones}
    if spec.mixer in ("full", "swa"):
        p["attn"] = _init_attn(draw, cfg, dtype, lead)
    elif spec.mixer == "mla":
        p["attn"] = init_mla(draw, cfg, dtype, lead)
    elif spec.mixer == "rec":
        p["rec"] = rglru.init_rglru_block(draw, cfg, dtype, lead)
    elif spec.mixer == "rwkv":
        p["rwkv"] = rwkv6.init_rwkv_block(draw, cfg, dtype, lead)
    else:
        raise ValueError(spec.mixer)
    p["norm2"] = ones.clone()
    if spec.ffn == "dense":
        d_ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.dense_d_ff is not None:
            d_ff = cfg.moe.dense_d_ff
        p["mlp"] = init_mlp(draw, cfg.d_model, d_ff, cfg.mlp, dtype=dtype, lead=lead)
    elif spec.ffn == "moe":
        p["moe"] = init_moe(draw, cfg.d_model, cfg.moe, cfg.d_ff, cfg.mlp,
                            dtype=dtype, lead=lead)
    return p


def init(generator: torch.Generator, cfg: LMConfig,
         device: str | torch.device = "cuda") -> dict[str, Any]:
    """Random parameters shaped like the JAX package's ``init``.

    Normals are drawn from ``generator`` on the generator's own device (a
    CUDA generator draws a full-width model on the card) and placed on
    ``device``.  Torch cannot replay ``jax.random``, so parity tests bridge
    the JAX parameters instead (:func:`repro_torch.interop.params_from_jax`).
    """
    dev = resolve_device(device)
    dtype = _dtype(cfg.param_dtype)

    def draw(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=generator.device).to(dev)

    params: dict[str, Any] = {
        "embed": (draw((cfg.padded_vocab, cfg.d_model)) * 0.02).to(dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.pos == "learned":
        params["pos"] = (draw((cfg.max_seq_len, cfg.d_model)) * 0.02).to(dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_linear(draw, cfg.d_model, cfg.padded_vocab, dtype=dtype)
    params["stages"] = [
        {f"sub{i}": _init_layer(draw, cfg, sp, dtype, (repeats,), dev)
         for i, sp in enumerate(specs)}
        for specs, repeats in stage_plan(cfg)]
    return params


def compute_copy(params, cfg: LMConfig, device: str | torch.device = "cuda"):
    """The parameter tree on ``device`` with every weight in the compute dtype.

    The layers cast each weight to the activation dtype at every call, as the
    JAX package does; a tree already in that dtype makes those casts no-ops
    with the same values, and halves the bytes a bf16 decode step reads.  The
    leaves the layers read in float32 (``_F32_LEAVES``: the RG-LRU's ``lam``,
    the MoE router, RWKV's ``w0`` and ``u``) keep their dtype.  Leaves
    already in place are shared, not copied, so serving planes handed one
    compute copy share one set of weight tensors.
    """
    dev = resolve_device(device)
    cdtype = _dtype(cfg.dtype)

    def walk(node, keep=False):
        if isinstance(node, dict):
            return {k: walk(v, keep or k in _F32_LEAVES) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, keep) for v in node]
        return node.to(device=dev, dtype=node.dtype if keep else cdtype)

    return walk(params)


# -------------------------------------------------------------------- mixers
def _attn_mixer(p, cfg: LMConfig, spec: LayerSpec, x, positions, *, mode,
                cache=None, lengths=None, paged=None, shardings=None):
    """Returns (out, cache).  In decode and prefill the given cache is
    written in place.

    ``paged``: the ``PagedTables`` of a decode step against a paged pool
    (``init_paged_cache``; see ``decode_step``).  Applies to seq-dim caches
    only (full-attention k/v, MLA ckv/kpe); swa rings and recurrent state
    stay per lane.
    """
    b, s, _ = x.shape
    hd = cfg.hd
    window = cfg.window if spec.mixer == "swa" else None

    if spec.mixer == "mla":
        if mode == "decode":
            y, ckv, kpe = mla_decode(p["attn"], cfg, x, cache["ckv"], cache["kpe"],
                                     lengths, paged=paged)
            return y, {"ckv": ckv, "kpe": kpe}
        y, (c_kv, k_pe) = mla_attention(p["attn"], cfg, x, positions,
                                        blockwise=s > BLOCKWISE_THRESHOLD)
        if mode != "prefill":
            return y, None
        write_prefix(cache["ckv"], _constrain(c_kv.to(cache["ckv"].dtype), shardings, "ckv"))
        write_prefix(cache["kpe"], _constrain(k_pe.to(cache["kpe"].dtype), shardings, "ckv"))
        return y, cache

    a = p["attn"]
    # whole heads on every device before the head split (a DTensor view
    # cannot split a dim sharded unevenly across heads)
    q = _constrain(linear(a["wq"], x), shardings, "q").reshape(b, s, cfg.n_heads, hd)
    k = _constrain(linear(a["wk"], x), shardings, "kvh").reshape(b, s, cfg.n_kv_heads, hd)
    v = _constrain(linear(a["wv"], x), shardings, "kvh").reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_scaling)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_scaling)
    if mode == "prefill":
        # compute-path q/k/v stay batch-sharded (the S-sharded cache write
        # must not pull its layout onto them)
        q = _constrain(q, shardings, "qkv")
        k = _constrain(k, shardings, "qkv")
        v = _constrain(v, shardings, "qkv")
    if mode == "decode":
        rows = torch.arange(b, device=x.device)
        kc, vc = cache["k"], cache["v"]
        if window is not None:  # ring buffer of size window
            slot = lengths % window
            write_token(kc, slot, k[:, 0], rows)
            write_token(vc, slot, v[:, 0], rows)
            n_valid = torch.clamp(lengths + 1, max=window)
            out = _ring_decode(q, kc, vc, n_valid)
        elif paged is not None:
            # write the token's k/v at (physical block, offset), then attend
            # over this layer's gathered view: the transient is one layer's
            # [B, max_len] view, never the whole pool.  Positions >= lengths
            # + 1 (block tails, null-block rows of dead lanes) are masked.
            paged_write(kc, paged, k[:, 0])
            paged_write(vc, paged, v[:, 0])
            out = decode_attention(q, paged_view(kc, paged), paged_view(vc, paged),
                                   lengths + 1)
        else:
            write_token(kc, lengths, k[:, 0], rows)
            write_token(vc, lengths, v[:, 0], rows)
            out = decode_attention(q, kc, vc, lengths + 1)
        out = _constrain(out.reshape(b, 1, -1), shardings, "q")
        return linear(a["wo"], out), {"k": kc, "v": vc}

    # train / prefill
    if window is not None and s > 2 * window:
        out = banded_attention(q, k, v, window=window,
                               q_chunk=min(cfg.q_chunk, window))
    elif s > BLOCKWISE_THRESHOLD:
        out = blockwise_attention(q, k, v, causal=True, window=window,
                                  q_chunk=min(cfg.q_chunk, s),
                                  kv_chunk=min(cfg.kv_chunk, s))
    else:
        out = full_attention(q, k, v, causal=True, window=window)
    # pinned as q was, so that the backward's head split meets whole heads
    y = linear(a["wo"], _constrain(out.reshape(b, s, -1), shardings, "q"))

    if mode != "prefill":
        return y, None
    kc, vc = cache["k"], cache["v"]
    if window is not None:
        # the last min(s, window) positions land in ring slot position %
        # window; prefill positions are 0..s-1, so that is a roll of the tail
        # by s % window (a permutation, written whole, no indexed write)
        for c, new in ((kc, k), (vc, v)):
            if s >= window:
                write_prefix(c, roll_seq(new[:, -window:], s % window))
            else:
                c.zero_()
                write_prefix(c, new)
    else:
        # written in the cache's own layout, so the write is a local slice
        write_prefix(kc, _constrain(k.to(kc.dtype), shardings, "kv"))
        write_prefix(vc, _constrain(v.to(vc.dtype), shardings, "kv"))
    return y, {"k": kc, "v": vc}


def _ring_decode(q1, k_ring, v_ring, n_valid):
    """Decode against a ring buffer: all slots < n_valid (per batch) are live;
    slot order is irrelevant to attention."""
    kpos = torch.arange(k_ring.shape[1], device=q1.device)[None, :]
    mask = kpos < n_valid[:, None]
    # reuse decode_attention by passing per-batch "length" = window validity
    return decode_attention(q1, torch.where(mask[..., None, None], k_ring, 0),
                            v_ring, n_valid)


# --------------------------------------------------------------------- layers
def _layer_apply(p, cfg: LMConfig, spec: LayerSpec, x, positions, *, mode,
                 cache=None, lengths=None, paged=None, shardings=None):
    """One block.  Returns (x, new_cache, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["norm1"].to(x.dtype), cfg.norm_eps)
    if spec.mixer == "rec":
        out, new_cache = rglru.rglru_block(p["rec"], cfg, h,
                                           cache=None if mode == "train" else cache)
    elif spec.mixer == "rwkv":
        out, new_cache = rwkv6.time_mix(p["rwkv"], cfg, h,
                                        cache=None if mode == "train" else cache["tm"])
    elif mode == "train":
        out = spanned("attention", lambda h: _attn_mixer(
            p, cfg, spec, h, positions, mode=mode, shardings=shardings)[0], h)
        new_cache = None
    else:
        out, new_cache = _attn_mixer(p, cfg, spec, h, positions, mode=mode,
                                     cache=cache, lengths=lengths, paged=paged,
                                     shardings=shardings)
    x = x + out
    h2 = rms_norm(x, p["norm2"].to(x.dtype), cfg.norm_eps)
    if spec.ffn == "rwkv":
        out2, cm_cache = rwkv6.channel_mix(p["rwkv"], cfg, h2,
                                           cache=None if mode == "train" else cache["cm"])
        new_cache = None if mode == "train" else {"tm": new_cache, "cm": cm_cache}
    elif spec.ffn == "moe":
        out2, aux = moe_ffn(p["moe"], h2, cfg.moe, cfg.mlp,
                            groups=(shardings or {}).get("moe_groups", 1))
    else:
        out2 = mlp(p["mlp"], h2, cfg.mlp)
    return x + out2, new_cache, aux


def _write(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is not dst:
        dst.copy_(src)


def _run_stages(params, cfg: LMConfig, x, positions, *, mode, caches=None,
                lengths=None, remat=False, paged=None, shardings=None):
    """Each stage's repeats in order; a layer's new cache is written into its
    slice of the stacked cache.  Returns (x, caches, aux_total): the sum of
    the layers' auxiliary losses (the MoE load-balancing terms), float32.

    ``remat`` (train mode only: no caches): each repeat's layers run under
    ``torch.utils.checkpoint``, as the JAX package wraps its scan body in
    ``jax.checkpoint``, so the backward pass recomputes their activations.
    """
    plan = stage_plan(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (specs, repeats), stage_p, stage_c in zip(
            plan, params["stages"], caches or [None] * len(plan)):
        for r in range(repeats):
            lp = tree_map(lambda t: t[r], stage_p)
            lc = None if stage_c is None else tree_map(lambda t: t[r], stage_c)

            def body(x, lp=lp, lc=lc, specs=specs):
                aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
                for i, sp in enumerate(specs):
                    sub_c = None if lc is None else lc[f"sub{i}"]
                    x, nc, aux = _layer_apply(lp[f"sub{i}"], cfg, sp, x, positions,
                                              mode=mode, cache=sub_c, lengths=lengths,
                                              paged=paged, shardings=shardings)
                    x = _constrain(x, shardings, "act")
                    if sub_c is not None:
                        tree_map(_write, sub_c, nc)
                    aux_sum = aux_sum + aux
                return x, aux_sum

            x, aux = (checkpoint(body, x, use_reentrant=False)
                      if remat and torch.is_grad_enabled() else body(x))
            aux_total = aux_total + aux
    return x, caches, aux_total


# ----------------------------------------------------------------- public API
def _rows(table, idx):
    """``table[idx]``.  For DTensor indices it is an embedding lookup
    (``F.embedding``, whose DTensor rule handles a vocab-split table and
    whose backward is a dense one, where the indexing's backward is an
    ``index_put``); indices whose dim 0 is split over several mesh axes
    (``("pod", "data")``) are first split over the minor one only, since
    DTensor's lookup takes one mesh axis a dim, and the ``"act"`` hint
    splits the rows again, locally."""
    if not is_dtensor(idx):
        return table[idx]
    from torch.distributed.tensor import Replicate

    out = torch.nn.functional.embedding(minor_split(idx), table)
    # a vocab-split table gives a masked partial sum: reduce it here, once
    return out.redistribute(out.device_mesh, [Replicate() if p.is_partial() else p
                                              for p in out.placements])


def embed_tokens(params, cfg: LMConfig, tokens, *, prefix_embeds=None,
                 pos_offset=None):
    """tokens: [B, S] int -> (x [B, S(+P), d] in compute dtype, positions).

    ``prefix_embeds`` [B, P, d] (the patch/frame frontends' precomputed
    embeddings) are prepended to the token embeddings.
    """
    cdtype = _dtype(cfg.dtype)
    x = _rows(params["embed"], tokens).to(cdtype)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(cdtype), x], dim=1)
    b, s, _ = x.shape
    steps = torch.arange(s, device=x.device)[None]
    if pos_offset is None:
        positions = steps.expand(b, s)
    else:
        positions = pos_offset[:, None] + steps
    if cfg.pos == "learned":
        x = x + _rows(params["pos"], positions).to(cdtype)
    return x, positions


def logits_fn(params, cfg: LMConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]["w"]
    logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab:
        # mask padding columns so softmax/argmax never see them
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = torch.where(pad_mask, torch.tensor(NEG_INF, dtype=logits.dtype,
                                                    device=x.device), logits)
    return logits


def forward(params, cfg: LMConfig, tokens, *, prefix_embeds=None, remat=False,
            shardings=None):
    """Training forward.  Returns (logits [B, S(+P), V], aux_loss)."""
    x, positions = embed_tokens(params, cfg, tokens, prefix_embeds=prefix_embeds)
    x = _constrain(x, shardings, "act")
    x, _, aux = _run_stages(params, cfg, x, positions, mode="train", remat=remat,
                            shardings=shardings)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return _constrain(logits_fn(params, cfg, x), shardings, "logits"), aux


def backbone(params, cfg: LMConfig, x_embeds, *, remat=False, shardings=None):
    """Run the block stack on precomputed embeddings (ST-LLM's node tokens).
    x_embeds: [B, S, d] -> (hidden [B, S, d], aux).

    Runs where ``x_embeds`` and ``params`` lie.  ``aux`` is the layers'
    summed auxiliary loss, float32 (zero without MoE layers).  Train mode
    writes no cache, so the whole pass is differentiable.
    """
    b, s, _ = x_embeds.shape
    positions = torch.arange(s, device=x_embeds.device)[None].expand(b, s)
    x = _constrain(x_embeds.to(_dtype(cfg.dtype)), shardings, "act")
    x, _, aux = _run_stages(params, cfg, x, positions, mode="train", remat=remat,
                            shardings=shardings)
    return rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps), aux


def loss_fn(params, cfg: LMConfig, tokens_in, labels, *, prefix_embeds=None,
            remat=False, shardings=None):
    """Next-token cross-entropy (+ MoE aux).  labels: [B, S] (-1 = ignore).
    Returns (loss + aux, {"nll": loss, "aux": aux}).

    With ``shardings`` the gold logit is a one-hot select, as the JAX
    package takes it: it stays local to a vocab-sharded logits axis, where a
    gather along that axis would all-gather the [B, S, V] float32 logits.
    Both give the same value; the gather makes no [B, S, V] mask.
    """
    logits, aux = forward(params, cfg, tokens_in, prefix_embeds=prefix_embeds,
                          remat=remat, shardings=shardings)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels >= 0
    if shardings is None:
        gold = torch.gather(logits, -1,
                            torch.where(valid, labels, 0).long()[..., None])[..., 0]
    else:
        hit = labels[..., None] == torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.sum(torch.where(hit, logits, 0.0), dim=-1)
    nll = torch.where(valid, lse - gold, 0.0)
    loss = torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
    return loss + aux, {"nll": loss, "aux": aux}


# -------------------------------------------------------------------- serving
def _token_leaves(cfg: LMConfig, spec: LayerSpec, lead: tuple, dev: torch.device):
    """The attention leaves of one stage slot, a row per cached token:
    ``lead`` is ``(repeats, batch, positions)`` for per-lane lines and
    ``(repeats, num_blocks, block_size)`` for a paged pool."""
    cdtype = _dtype(cfg.dtype)
    if spec.mixer == "mla":
        m = cfg.mla
        return {"ckv": torch.zeros(lead + (m.kv_lora_rank,), dtype=cdtype, device=dev),
                "kpe": torch.zeros(lead + (m.qk_rope_head_dim,), dtype=cdtype, device=dev)}
    shape = lead + (cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cdtype, device=dev)}


def _lane_cache(cfg: LMConfig, spec: LayerSpec, repeats: int, batch: int,
                max_len: int, dev: torch.device):
    """One stage slot's per-lane cache leaves, ``[repeats, batch, ...]``."""
    if spec.mixer in ("full", "mla"):
        return _token_leaves(cfg, spec, (repeats, batch, max_len), dev)
    if spec.mixer == "swa":
        return _token_leaves(cfg, spec, (repeats, batch, min(cfg.window, max_len)), dev)
    cdtype = _dtype(cfg.dtype)
    if spec.mixer == "rwkv":
        c = rwkv6.init_rwkv_cache(cfg, batch, cdtype, dev)
    else:
        c = rglru.init_rglru_cache(cfg, batch, cdtype, dev)
    return tree_map(lambda v: v.expand((repeats,) + v.shape).contiguous(), c)


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device: str | torch.device = "cuda"):
    """Cache tree mirroring the stage plan (stacked over repeats)."""
    dev = resolve_device(device)
    return [{f"sub{i}": _lane_cache(cfg, sp, repeats, batch, max_len, dev)
             for i, sp in enumerate(specs)}
            for specs, repeats in stage_plan(cfg)]


def _put_lanes(big, small, slots):
    if is_dtensor(big):
        return _put_on_shards(big, small, np.asarray(slots).reshape(-1), 1)
    big[:, torch.as_tensor(slots, dtype=torch.long, device=big.device)] = small.to(big.dtype)
    return big


def _put_on_shards(big, small, rows: np.ndarray, lead: int):
    """``big[:, rows] = small`` for a DTensor ``big`` whose dim 1 (lanes,
    or pool blocks) may be split over mesh dims (``launch/sharding``'s
    cache rules put it on the data axes), in place: ``small`` (``[R, len(
    rows), ...]`` after ``lead`` - 1 more index dims folded into one) takes
    ``big``'s layout with dim 1 whole, and each rank writes the rows it
    holds.  ``rows`` are host indices, so the choice costs no device sync."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = big.device_mesh
    whole = [Replicate() if p == Shard(1) else
             Shard(p.dim + lead - 1) if isinstance(p, Shard) and p.dim > 1 else p
             for p in big.placements]
    small_l = as_dtensor(small, mesh).redistribute(mesh, whole).to_local()
    small_l = small_l.reshape((small_l.shape[0], -1) + tuple(small_l.shape[1 + lead:]))
    big_l = big.to_local()
    lo = local_offset(big, 1)
    mine = np.flatnonzero((rows >= lo) & (rows < lo + big_l.shape[1]))
    if mine.size:
        dev = big_l.device
        big_l[:, torch.as_tensor(rows[mine] - lo, device=dev)] = \
            small_l[:, torch.as_tensor(mine, device=dev)].to(big_l.dtype)
    return big


def scatter_cache(cache, sub, slots):
    """Write a k-batch cache tree into k (arbitrary, non-contiguous) lanes of
    a pool cache, in place.

    ``cache``: the slot-pool cache from ``init_cache`` (every leaf
    stage-stacked ``[repeats, batch, ...]``, batch at axis 1).  ``sub``: the
    same tree with batch ``k`` (a batched-prefill output).  ``slots``: ``[k]``
    lane indices.  One indexed write per leaf.
    """
    return tree_map(lambda big, small: _put_lanes(big, small, slots), cache, sub)


# ------------------------------------------------------------ paged KV-cache
def init_paged_cache(cfg: LMConfig, batch: int, max_len: int, *, num_blocks: int,
                     block_size: int, device: str | torch.device = "cuda"):
    """Paged cache pool: seq-dim leaves become shared block pools.

    Full-attention k/v and MLA ckv/kpe leaves are ``[repeats, num_blocks,
    block_size, ...]``: one pool per layer, shared by every lane through
    per-lane block tables (``serve.blocks.BlockPool`` owns the allocation;
    physical block 0 is the null block).  Per-lane state with no paged seq
    dim (swa rings, RG-LRU / RWKV recurrent state) keeps the ``init_cache``
    layout ``[repeats, batch, ...]``.
    """
    dev = resolve_device(device)

    def one_layer(spec: LayerSpec, repeats: int):
        if spec.mixer in ("full", "mla"):
            return _token_leaves(cfg, spec, (repeats, num_blocks, block_size), dev)
        return _lane_cache(cfg, spec, repeats, batch, max_len, dev)

    return [{f"sub{i}": one_layer(sp, repeats) for i, sp in enumerate(specs)}
            for specs, repeats in stage_plan(cfg)]


def paged_cache_mask(cfg: LMConfig):
    """Bool tree congruent with the cache: True at paged (seq-dim) leaves.

    Decided per layer SPEC, not by shape: a swa ring whose window equals
    ``max_len`` must still take the ring decode path, not the paged one.
    """
    def one_layer(spec: LayerSpec):
        paged = spec.mixer in ("full", "mla")
        return tree_map(lambda _: paged,
                        _lane_cache(cfg, spec, 1, 1, 1, torch.device("meta")))

    return [{f"sub{i}": one_layer(sp) for i, sp in enumerate(specs)}
            for specs, _ in stage_plan(cfg)]


def scatter_cache_paged(cache, sub, slots, phys, *, block_size: int, mask):
    """Land a k-batch contiguous prefill cache in a paged pool, in place.

    ``cache``: the pool from ``init_paged_cache``.  ``sub``: a contiguous
    prefill cache with batch k.  ``slots``: ``[k]`` lane ids, used for the
    per-lane (unpaged) leaves as in ``scatter_cache``.  ``phys``: ``[k, nb]``
    physical blocks covering logical positions ``0..nb*block_size`` of each
    lane (the prompt's blocks).  ``mask``: ``paged_cache_mask(cfg)``.

    Paged leaves cut (or zero-pad) the sub line to ``nb`` blocks and write
    them to their physical rows in one indexed write; positions past the
    prompt inside the last block are zero (masked by the lane lengths until
    decode overwrites them).
    """
    def put(is_paged, big, small):
        if not is_paged:
            return _put_lanes(big, small, slots)
        if is_dtensor(small):  # the group's lines, whole, for the cut and the fold
            small = small.full_tensor()
        small = small.to(big.dtype)
        r, k, s = small.shape[:3]
        nb = np.shape(phys)[1]
        want = nb * block_size
        if s > want:
            small = small[:, :, :want]
        elif s < want:
            small = zero_pad(small, 2, after=want - s)
        small = small.reshape((r, k, nb, block_size) + tuple(small.shape[3:]))
        if is_dtensor(big):
            return _put_on_shards(big, small, np.asarray(phys).reshape(-1), 2)
        big[:, torch.as_tensor(phys, dtype=torch.long, device=big.device)] = small
        return big

    return tree_map(put, mask, cache, sub)


def prefill(params, cfg: LMConfig, tokens, cache, *, prefix_embeds=None,
            shardings=None):
    """Fill ``cache`` (in place) from a prompt (after ``prefix_embeds``, when
    given).  Returns (last-token logits, cache, lengths)."""
    x, positions = embed_tokens(params, cfg, tokens, prefix_embeds=prefix_embeds)
    x = _constrain(x, shardings, "act")
    x, cache, _ = _run_stages(params, cfg, x, positions, mode="prefill", caches=cache,
                              shardings=shardings)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    logits = logits_fn(params, cfg, x[:, -1:])[:, 0]
    lengths = torch.full((tokens.shape[0],), x.shape[1], dtype=torch.long,
                         device=x.device)
    return logits, cache, lengths


def decode_step(params, cfg: LMConfig, token, cache, lengths, *, paged=None,
                shardings=None):
    """One decode step.  token: [B, 1], lengths: [B] -> (logits [B, V],
    cache), the cache written in place.

    ``paged``: ``(tables, block_size, max_len)`` when ``cache`` is a paged
    pool from ``init_paged_cache``: the tables ``[B, max_blocks]`` map each
    lane's logical blocks to physical pool blocks, and every layer writes and
    reads through them.  Each layer's gathered view is cut to ``max_len``:
    positions past it are never valid, so the function is JAX's (which takes
    ``(tables, block_size)`` and attends over the uncut view), and the view
    has the contiguous cache's shape at every block size.
    """
    x, positions = embed_tokens(params, cfg, token, pos_offset=lengths)
    x = _constrain(x, shardings, "act")
    if paged is not None:  # the write positions, once for every layer
        paged = paged_tables(paged, lengths)
    x, cache, _ = _run_stages(params, cfg, x, positions, mode="decode",
                              caches=cache, lengths=lengths, paged=paged,
                              shardings=shardings)
    x = rms_norm(x, params["final_norm"].to(x.dtype), cfg.norm_eps)
    return logits_fn(params, cfg, x[:, 0]), cache
