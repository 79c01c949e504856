"""Multi-head Latent Attention (DeepSeek-V2): a compressed KV cache.

Projections:  q = W_q x  -> per-head (nope ‖ rope) query
              [c_kv ‖ k_pe] = W_dkv x   (kv_lora_rank + rope_dim: the CACHE)
              k_nope, v = W_ukv · rmsnorm(c_kv)

Prefill and train decompress k and v and run standard attention.  Decode
uses the *absorbed* form: q_nope is folded through W_uk into the latent
space, scores are taken against the cached ``c_kv`` directly, and W_uv is
applied to the attended latent, so a token costs ``kv_lora_rank + rope_dim``
(576) cache entries instead of ``2·H·D``.  As in the JAX package; decode
writes the given cache in place, a contiguous line per lane or a paged pool
of blocks read through block tables.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.lm.attention import (NEG_INF, blockwise_attention, full_attention,
                                              paged_tables, paged_view, paged_write,
                                              write_token, zero_pad)
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import (Draw, apply_rope, init_linear, linear, rms_norm,
                                          yarn_mscale)


def init_mla(draw: Draw, cfg: LMConfig, dtype=torch.float32, lead: tuple = ()):
    m = cfg.mla
    h = cfg.n_heads
    wq = init_linear(draw, cfg.d_model, h * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                     dtype=dtype, lead=lead)
    return {
        "wq": wq,
        "wdkv": init_linear(draw, cfg.d_model, m.kv_lora_rank + m.qk_rope_head_dim,
                            dtype=dtype, lead=lead),
        "ckv_norm": torch.ones(lead + (m.kv_lora_rank,), dtype=dtype,
                               device=wq["w"].device),
        "wukv": init_linear(draw, m.kv_lora_rank, h * (m.qk_nope_head_dim + m.v_head_dim),
                            dtype=dtype, lead=lead),
        "wo": init_linear(draw, h * m.v_head_dim, cfg.d_model, dtype=dtype, lead=lead),
    }


def _project_q(p, cfg: LMConfig, x, positions):
    m = cfg.mla
    b, s, _ = x.shape
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    qn, qr = torch.split(q, [m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return qn, apply_rope(qr, positions, cfg.rope_theta, cfg.rope_scaling)


def _project_ckv(p, cfg: LMConfig, x, positions):
    m = cfg.mla
    c_kv, k_pe = torch.split(linear(p["wdkv"], x),
                             [m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["ckv_norm"].to(x.dtype), cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta,
                      cfg.rope_scaling)[:, :, 0]
    return c_kv, k_pe  # [B,S,r], [B,S,dr]


def softmax_scale(cfg: LMConfig) -> float | None:
    """MLA's softmax scale: ``(nope + rope) ** -0.5``, times YaRN's
    ``mscale(factor, mscale_all_dim) ** 2`` (DeepSeek-V2's attention) where
    the config has YaRN with ``mscale_all_dim``; None for the plain
    ``1 / sqrt(head dim)`` the attention functions take by default."""
    y = cfg.rope_scaling
    if y is None or not y.mscale_all_dim:
        return None
    m = yarn_mscale(y.factor, y.mscale_all_dim)
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5 * m * m


def mla_attention(p, cfg: LMConfig, x, positions, *, blockwise: bool = False):
    """Train/prefill path (decompressed).  x: [B, S, d] -> ([B, S, d],
    (c_kv, k_pe))."""
    m = cfg.mla
    b, s, _ = x.shape
    qn, qr = _project_q(p, cfg, x, positions)
    c_kv, k_pe = _project_ckv(p, cfg, x, positions)
    kv = linear(p["wukv"], c_kv).reshape(b, s, cfg.n_heads,
                                         m.qk_nope_head_dim + m.v_head_dim)
    kn, v = torch.split(kv, [m.qk_nope_head_dim, m.v_head_dim], dim=-1)
    k = torch.cat([kn, k_pe[:, :, None, :].expand(qr.shape)], dim=-1)
    q = torch.cat([qn, qr], dim=-1)
    # v's head dim may differ from the qk head dim: pad v for the shared path
    vp = zero_pad(v, -1, after=q.shape[-1] - m.v_head_dim)
    fn = blockwise_attention if blockwise else full_attention
    out = fn(q, k, vp, causal=True, scale=softmax_scale(cfg))
    y = linear(p["wo"], out[..., :m.v_head_dim].reshape(b, s, -1))
    return y, (c_kv, k_pe)


def mla_decode(p, cfg: LMConfig, x1, ckv_cache, kpe_cache, lengths, *, paged=None):
    """Absorbed one-token decode.  x1: [B, 1, d]; caches: [B, S_max, r] /
    [B, S_max, dr], written in place at ``lengths``.

    Returns (y [B, 1, d], ckv_cache, kpe_cache).  ``paged``: ``(tables,
    block_size, max_len)`` when the caches are paged pools ``[num_blocks,
    block_size, r]``: the new latent is written at its (physical block,
    offset) and attention runs over the block-table gathered view, cut to
    ``max_len``; the pools are returned.
    """
    m = cfg.mla
    b = x1.shape[0]
    pos = lengths[:, None]  # [B,1] absolute position of the new token
    qn, qr = _project_q(p, cfg, x1, pos)
    c_new, kpe_new = _project_ckv(p, cfg, x1, pos)
    if paged is None:
        rows = torch.arange(b, device=x1.device)
        write_token(ckv_cache, lengths, c_new[:, 0], rows)
        write_token(kpe_cache, lengths, kpe_new[:, 0], rows)
        ckv, kpe = ckv_cache, kpe_cache
    else:
        paged = paged_tables(paged, lengths)
        paged_write(ckv_cache, paged, c_new[:, 0])
        paged_write(kpe_cache, paged, kpe_new[:, 0])
        # positions past lengths are masked below, so stale block tails
        # cannot contribute
        ckv = paged_view(ckv_cache, paged)
        kpe = paged_view(kpe_cache, paged)

    # Absorb W_uk: q_lat[h] = W_uk[h]^T q_nope[h] -> score against c_kv directly.
    wukv = p["wukv"]["w"].reshape(m.kv_lora_rank, cfg.n_heads,
                                  m.qk_nope_head_dim + m.v_head_dim)
    w_uk = wukv[..., :m.qk_nope_head_dim]  # [r, H, dn]
    w_uv = wukv[..., m.qk_nope_head_dim:]  # [r, H, dv]
    q_lat = torch.einsum("bqhd,rhd->bqhr", qn, w_uk.to(x1.dtype))  # [B,1,H,r]
    scale = softmax_scale(cfg) or 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    scores = (torch.einsum("bqhr,bkr->bhqk", q_lat.float(), ckv.float())
              + torch.einsum("bqhd,bkd->bhqk", qr.float(), kpe.float())) * scale
    kpos = torch.arange(ckv.shape[1], device=x1.device)[None, None, None, :]
    mask = kpos <= lengths[:, None, None, None]
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkr->bqhr", probs.to(ckv.dtype), ckv)
    v = torch.einsum("bqhr,rhd->bqhd", ctx, w_uv.to(x1.dtype))
    y = linear(p["wo"], v.reshape(b, 1, -1))
    return y, ckv_cache, kpe_cache
