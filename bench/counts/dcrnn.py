"""Model FLOPs and hop shapes of DCRNN (``bench/models/dcrnn.py``).

A counts module (``bench/counts/<reference>.py``) exports ``flops``; a
model with diffusion hops also ``hop_shapes`` and ``backward_hop_shapes``."""
from __future__ import annotations

from bench.counts.dconv import dconv_flops, hop_shape, project_flops


def _cells(cfg: dict):
    """``(input width c, input needs a gradient in training)`` of each GRU
    cell of one forward, in order."""
    h, layers = cfg["hidden"], cfg["layers"]
    for t in range(cfg["input_len"]):
        for i in range(layers):
            # only the first cell sees neither a gradient-carrying input
            # nor a gradient-carrying state
            yield (cfg["in_features"] if i == 0 else h) + h, not (t == 0 and i == 0)
    for _ in range(cfg["horizon"]):
        for i in range(layers):
            yield (cfg["out_features"] if i == 0 else h) + h, True


def flops(cfg: dict, batch: int, *, train: bool) -> int:
    """Product FLOPs of one forward (``train``: with its backward) over a
    batch of ``batch`` windows."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    total = 0
    for c, grad in _cells(cfg):
        total += dconv_flops(n, batch, c, 2 * h, k, train=train, input_grad=grad)
        total += dconv_flops(n, batch, c, h, k, train=train, input_grad=True)
    return total + cfg["horizon"] * project_flops(n, batch, h, cfg["out_features"],
                                                  train=train)


def hop_shapes(cfg: dict, batch: int) -> list[tuple]:
    """``(n, b, c, h)`` of every hop of one forward."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    shapes = []
    for c, _ in _cells(cfg):
        shapes += hop_shape(n, batch, c, 2 * h, k) + hop_shape(n, batch, c, h, k)
    return shapes


def backward_hop_shapes(cfg: dict, batch: int) -> list[tuple]:
    """``(n, b, c, h)`` of every hop a training step runs backward: those
    whose input needs a gradient (the supports never do)."""
    n, h, k = cfg["num_nodes"], cfg["hidden"], cfg["max_diffusion_step"]
    shapes = []
    for c, grad in _cells(cfg):
        shapes += (hop_shape(n, batch, c, 2 * h, k) if grad else []) \
            + hop_shape(n, batch, c, h, k)
    return shapes
