"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU gated recurrence.

RG-LRU:  r_t = sigmoid(W_a x_t + b_a)          recurrence gate
         i_t = sigmoid(W_x x_t + b_x)          input gate
         a_t = exp(-c * softplus(Lambda) * r_t)            (c = 8)
         h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear in h, and :func:`rglru_scan` has the JAX package's
three branches.  Training (no cache) takes the default ``use_assoc=True``:
``loops.associative_scan``, the JAX package's ``jax.lax.associative_scan``
in its own association, so ``h`` equals the reference's bit for bit on the
same ``(a, b)``.  The cache branch (prefill and decode) passes
``use_assoc=False``, as the reference does: the sequential scan, the plain
``linear_scan``, which rounds each step's product and sum (as the CUDA
kernel does) where XLA's CPU backend contracts the reference's ``lax.scan``
step into one FMA: the two agree within float32 rounding.
``use_pallas`` (``LMConfig.use_pallas_scan``) runs either through the
hand-written CUDA ``linear_scan``, which equals the sequential scan.
Decode carries (h, conv tail) as the layer's cache.
"""
from __future__ import annotations

import torch

from repro_torch.core.distributed import is_dtensor
from repro_torch.kernels.linear_scan import linear_scan
from repro_torch.kernels.linear_scan.ops import scan_on_whole_sequences
from repro_torch.loops import associative_scan
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


def _combine(l, r):
    """(a, h) of two spans, the earlier ``l`` then ``r``: the reference's
    ``(l0 * r0, l1 * r0 + r1)``."""
    return l[0] * r[0], l[1] * r[0] + r[1]


def _assoc_scan(a, b, h0=None):
    """h over the sequence by the associative scan (float32 ``a``, ``b``);
    ``h0`` folded in as a virtual step 0 (``a`` = 1, ``b`` = h0) and that
    step dropped, as the reference does.  Returns ``(h, h[:, -1])``."""
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        b = torch.cat([h0[:, None].float(), b], dim=1)
    _, h = associative_scan(_combine, (a, b), dim=1)
    if h0 is not None:
        h = h[:, 1:]
    return h, h[:, -1]


def rglru_scan(p, x, h0=None, *, use_assoc: bool = True, use_pallas: bool = False):
    """Linear recurrence over the sequence.  x: [B, S, w] -> (y, h_last),
    both in x's dtype.  The reference's branches: ``use_pallas`` (the CUDA
    scan), else ``use_assoc`` (the associative scan), else the sequential
    scan."""
    a, b = _gates(p, x)
    h0_ = None if h0 is None else h0.float()
    if use_pallas:
        h, h_last = linear_scan(a.contiguous(), b.contiguous(), h0_, use_pallas=True)
        return h.to(x.dtype), h_last.to(x.dtype)
    if use_assoc:
        h, _ = (scan_on_whole_sequences(_assoc_scan, a, b, h0) if is_dtensor(a)
                else _assoc_scan(a, b, h0))
    else:
        h, _ = linear_scan(a, b, h0_)
    return h.to(x.dtype), h[:, -1].to(x.dtype)


def rglru_block(p, cfg: LMConfig, x, *, cache=None):
    """Full Griffin recurrent block.  x: [B, S, d] -> (y, new_cache).

    cache = {"h": [B, w], "conv": [B, W-1, w]} or None (train from 0).
    With a cache (prefill and decode) the scan is sequential, as the
    reference's is; without one it is associative.
    """
    width = p["conv_w"].shape[0]
    gate = gelu(linear(p["in_gate"], x))
    u = linear(p["in_x"], x)
    if cache is not None:
        u_ext = torch.cat([cache["conv"].to(u.dtype), u], dim=1)
        conv = _causal_conv1d(p, u_ext)[:, width - 1:]
        h_seq, h_last = rglru_scan(p, conv, h0=cache["h"], use_assoc=False,
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
