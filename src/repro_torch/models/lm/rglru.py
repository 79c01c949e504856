"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU gated recurrence.

RG-LRU:  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
         i_t = sigmoid(W_x x_t + b_x)          input gate
         a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear in h.  ``use_pallas`` (``LMConfig.use_pallas_scan``)
runs it through the hand-written CUDA ``linear_scan``; otherwise through the
kernel's plain sequential version (the JAX package's associative scan gives
the same values within float32 rounding).  Decode carries (h, conv tail) as
the layer's cache.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.models.lm.attention import zero_pad
from repro_torch.models.lm.config import LMConfig
from repro_torch.models.lm.layers import Draw, gelu, init_linear, linear

_C = 8.0


def init_rglru_block(draw: Draw, cfg: LMConfig, dtype=torch.float32,
                     lead: tuple = ()):
    w = cfg.lru_width or cfg.d_model
    in_x = init_linear(draw, cfg.d_model, w, dtype=dtype, lead=lead)
    dev = in_x["w"].device
    # Lambda init so a^c in ~(0.9, 0.999) (Griffin appendix)
    lam = torch.log(torch.expm1(
        -torch.log(torch.linspace(0.9, 0.999, w, dtype=torch.float32)) / _C))
    return {
        "in_x": in_x,
        "in_gate": init_linear(draw, cfg.d_model, w, dtype=dtype, lead=lead),
        "conv_w": (draw(lead + (cfg.conv1d_width, w)) * 0.1).to(dtype),
        "conv_b": torch.zeros(lead + (w,), dtype=dtype, device=dev),
        "wa": init_linear(draw, w, w, dtype=dtype, lead=lead),
        "wx": init_linear(draw, w, w, dtype=dtype, lead=lead),
        "lam": lam.to(dev).expand(lead + (w,)).contiguous(),
        "out": init_linear(draw, w, cfg.d_model, dtype=dtype, lead=lead),
    }


def _causal_conv1d(p, x):
    """Depthwise causal conv, width W.  x: [B, S, w].  Summed tap by tap in
    the JAX package's order."""
    width = p["conv_w"].shape[0]
    xp = zero_pad(x, 1, width - 1)
    out = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][i].to(x.dtype)
              for i in range(width))
    return out + p["conv_b"].to(x.dtype)


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (torch's softplus
    returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p, x):
    """(a, b) of the recurrence, float32."""
    r = torch.sigmoid(linear(p["wa"], x).float())
    i = torch.sigmoid(linear(p["wx"], x).float())
    decay = _C * _softplus(p["lam"])  # [w], f32
    log_a = -decay * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) with a = exp(log_a); stable via expm1.
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))
    b = beta * i * x.float()
    return a, b


def rglru_scan(p, x, h0=None, *, use_pallas: bool = False):
    """Linear recurrence over the sequence.  x: [B, S, w] -> (y, h_last),
    both in x's dtype."""
    a, b = _gates(p, x)
    h0_ = None if h0 is None else h0.float()
    h, h_last = linear_scan(a.contiguous(), b.contiguous(), h0_,
                            use_pallas=use_pallas)
    return h.to(x.dtype), h_last.to(x.dtype)


def rglru_block(p, cfg: LMConfig, x, *, cache=None):
    """Full Griffin recurrent block.  x: [B, S, d] -> (y, new_cache).

    cache = {"h": [B, w], "conv": [B, W-1, w]} or None (train from 0).
    """
    width = p["conv_w"].shape[0]
    gate = gelu(linear(p["in_gate"], x))
    u = linear(p["in_x"], x)
    if cache is not None:
        u_ext = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
        conv = _causal_conv1d(p, u_ext)[:, width - 1:]
        h_seq, h_last = rglru_scan(p, conv, h0=cache["h"],
                                   use_pallas=cfg.use_pallas_scan)
        new_cache = {"h": h_last, "conv": u_ext[:, -(width - 1):]}
    else:
        conv = _causal_conv1d(p, u)
        h_seq, h_last = rglru_scan(p, conv, use_pallas=cfg.use_pallas_scan)
        new_cache = {"h": h_last, "conv": u[:, -(width - 1):]}
    return linear(p["out"], h_seq * gate), new_cache


def init_rglru_cache(cfg: LMConfig, batch: int, dtype, device) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, w), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                            device=device),
    }
