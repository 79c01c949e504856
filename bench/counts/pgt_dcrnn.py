"""Model FLOPs and hop shapes of PGT-DCRNN (``bench/models/pgt_dcrnn.py``)."""
from __future__ import annotations

from bench.counts.dconv import dconv_flops, hop_shape, project_flops


def flops(cfg: dict, batch: int, *, train: bool) -> int:
    """Product FLOPs of one forward (``train``: with its backward) over a
    batch of ``batch`` windows."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    c = cfg["in_features"] + h
    total = 0
    for t in range(cfg["input_len"]):
        # at t = 0 neither the input nor the zero state needs a gradient
        total += dconv_flops(n, batch, c, 2 * h, k, train=train, input_grad=t > 0)
        total += dconv_flops(n, batch, c, h, k, train=train, input_grad=True)
        total += project_flops(n, batch, h, cfg["out_features"], train=train)
    return total


def hop_shapes(cfg: dict, batch: int) -> list[tuple]:
    """``(n, b, c, h)`` of every hop of one forward."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    c = cfg["in_features"] + h
    return (hop_shape(n, batch, c, 2 * h, k) + hop_shape(n, batch, c, h, k)) \
        * cfg["input_len"]


def backward_hop_shapes(cfg: dict, batch: int) -> list[tuple]:
    """``(n, b, c, h)`` of every hop a training step runs backward: those
    whose input needs a gradient (at t = 0 the first DConv's does not)."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    c = cfg["in_features"] + h
    return hop_shape(n, batch, c, h, k) + (hop_shape(n, batch, c, 2 * h, k)
                                           + hop_shape(n, batch, c, h, k)) \
        * (cfg["input_len"] - 1)
