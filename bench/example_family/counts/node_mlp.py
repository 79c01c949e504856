"""Model FLOPs of the example family (``bench/example_family/models``):
2*m*n*k a product; in training each weight's gradient, and the input's
for every product but the first (the windows take no gradient). It has no
diffusion hops, so no ``hop_shapes``."""
from __future__ import annotations


def flops(cfg: dict, batch: int, *, train: bool) -> int:
    tokens = batch * cfg["num_nodes"]
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    t_in, out = cfg["input_len"] * cfg["in_features"], cfg["horizon"] * cfg["out_features"]
    # (k, n, the input needs a gradient) of each [tokens, k] @ [k, n]
    products = [(t_in, d, False), (d, ff, True), (d, ff, True), (ff, d, True), (d, out, True)]
    forward = sum(2 * tokens * k * n for k, n, _ in products)
    if not train:
        return forward
    return 2 * forward + sum(2 * tokens * k * n for k, n, grad in products if grad)
