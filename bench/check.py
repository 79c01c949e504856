"""The comparison that decides ``correct``: the reference (``bench/models``,
``bench/reference.py``) worked out again from the raw inputs, and the
numbers that hold the program's output against it.

Training: the losses and the gradients' global norms (before clipping) of
the first three steps, the first gradient as the optimiser took it and the
parameters' change over the three steps, each leaf held as a gap between
norms, the median leaf's compared. Forecasts:
the widest gap between a forecast and the reference's, in standard
deviations of the scaled feature.
"""
from __future__ import annotations

import importlib
import statistics

import numpy as np
import torch

from bench import reference as R
from bench.inputs import TRAFFIC, Inputs, leaves, put, stream_seed, to_device

#: A leaf whose first reference gradient is under this share of the median
#: leaf's moves under AdamW by round-off alone; its change is not compared.
STILL_LEAF = 1e-3


def reference_model(config: dict):
    return importlib.import_module(f"bench.models.{config['reference']}")


def _prepare(config: dict, inputs: Inputs, device):
    span = config["input_len"] + config["horizon"]
    train_end = int(inputs.splits["train"][-1]) + config["input_len"]
    scaler = R.fit_scaler(inputs.raw, train_end, device)
    graph = reference_model(config).graph(torch.from_numpy(inputs.adjacency).to(device))
    return span, scaler, graph


def reference_train(config: dict, traffic: dict, inputs: Inputs, batches, device,
                    precision: str = "float32") -> dict:
    """The reference's first ``len(batches)`` training steps from the
    initial weights: each step's loss and gradient norm before clipping,
    the first clipped gradient and the parameters after the last step, by
    path, on the host.

    The configuration's ``reference_windows`` (default: the whole batch)
    is how many windows one autograd pass takes: each part's loss is
    weighted by its share of the batch's windows and the parts' gradients
    summed, which is the batch's gradient of a loss that is a mean over
    windows, in the memory of one part."""
    model = reference_model(config)
    mm = R.product(precision)
    span, scaler, supports = _prepare(config, inputs, device)
    opt = R.AdamW(lr=traffic["lr"], grad_clip=traffic["grad_clip"])
    start = leaves(inputs.params)
    paths = list(start)
    params = [start[k].detach().to(device, copy=True) for k in paths]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, norms, first = [], [], None
    for step, ids in enumerate(batches, start=1):
        w = R.windows(inputs.raw, ids, span, scaler, device)
        x, y = w[:, :config["input_len"]], w[:, config["input_len"]:]
        live = [p.requires_grad_(True) for p in params]
        tree: dict = {}
        for k, p in zip(paths, live):
            put(tree, k, p)
        loss, grads = _loss_and_grads(model, tree, live, config, supports, x, y, mm)
        norms.append(R.global_norm(grads).item())
        grads = R.clip(grads, opt.grad_clip)
        losses.append(loss)
        if first is None:
            first = {k: g.cpu() for k, g in zip(paths, grads)}
        with torch.no_grad():
            params, m, v = R.adamw_step([p.detach() for p in live], grads, m, v, step, opt)
        del grads, live, tree, x, y, w
    return {"losses": losses, "grad_norms": norms, "first_gradient": first,
            "params": {k: p.cpu() for k, p in zip(paths, params)}}


def _loss_and_grads(model, tree, live, config, supports, x, y, mm):
    """The batch's loss (a float) and gradients, ``reference_windows``
    windows an autograd pass (one pass of the whole batch, weighted by 1,
    where it is not set)."""
    bsz = x.shape[0]
    part = config.get("reference_windows") or bsz
    loss, grads = 0.0, None
    for lo in range(0, bsz, part):
        share = min(part, bsz - lo) / bsz
        value = share * model.loss(tree, config, supports, x[lo:lo + part],
                                   y[lo:lo + part], mm)
        got = torch.autograd.grad(value, live)
        grads = list(got) if grads is None else [a + b for a, b in zip(grads, got)]
        loss += value.item()
    return loss, grads


@torch.no_grad()
def reference_forecast(config: dict, inputs: Inputs, batches, device,
                       precision: str = "float32") -> list[torch.Tensor]:
    """The reference's forecasts of each batch of window ids, on the host."""
    model = reference_model(config)
    mm = R.product(precision)
    span, scaler, supports = _prepare(config, inputs, device)
    params = to_device(inputs.params, device)
    out = []
    for ids in batches:
        w = R.windows(inputs.raw, ids, span, scaler, device)
        out.append(model.forward(params, config, supports,
                                 w[:, :config["input_len"]], mm).cpu())
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: dict, want: dict, paths) -> dict:
    """Each leaf's gap between the norms of ``got`` and ``want``, over the
    larger of that leaf's reference norm and the median leaf's."""
    ref = {k: _norm(want[k]) for k in paths}
    median = statistics.median(ref.values())
    return {k: abs(_norm(got[k]) - ref[k]) / max(ref[k], median, 1e-30) for k in paths}


def _leaf_gaps_of(got: dict, want: dict, start: dict) -> tuple[dict, dict]:
    """Per-leaf gaps of the first gradient and of the change over the steps
    (leaves the reference's first gradient leaves still are not compared)."""
    g_ref = want["first_gradient"]
    grads = leaf_gaps(got["first_gradient"], g_ref, list(g_ref))
    median = statistics.median(_norm(g) for g in g_ref.values())
    moving = [k for k, g in g_ref.items() if _norm(g) >= STILL_LEAF * median]
    start = {k: v.cpu() for k, v in start.items()}
    change = lambda p: {k: p[k] - start[k] for k in moving}
    return grads, leaf_gaps(change(got["params"]), change(want["params"]), moving)


def train_numbers(got: dict, want: dict, start: dict) -> dict:
    """``loss_gap``, ``grad_norm_gap``, ``grad_gap_median``,
    ``update_gap_median`` of a run (``got``) against the reference
    (``want``); ``start`` the initial weights by path.

    ``grad_norm_gap`` holds each step's global gradient norm before
    clipping: global-norm clipping and AdamW's ``m / sqrt(v)`` do not see a
    gradient scaled by one constant on every leaf, so the losses, the
    clipped gradient and the change can all agree while the backward is off
    by a factor.

    The gradient and the change are compared by their median leaf, not
    their worst: the output bias's gradient is the mean of
    ``sign(pred - y)``, which moves by ``2 / elements`` wherever rounding
    puts one forecast on the other side of its target, so the worst leaf's
    gap swings between seeds (:func:`worst_leaves`)."""
    def gap(key):
        return max(abs(a - b) / abs(b) for a, b in zip(got[key], want[key]))

    grads, updates = _leaf_gaps_of(got, want, start)
    return {"loss_gap": gap("losses"), "grad_norm_gap": gap("grad_norms"),
            "grad_gap_median": statistics.median(grads.values()),
            "update_gap_median": statistics.median(updates.values())}


def worst_leaves(got: dict, want: dict, start: dict) -> dict:
    """The gradient's and the change's worst leaf and gap (a diagnostic)."""
    out = {}
    for name, gaps in zip(("grad", "update"), _leaf_gaps_of(got, want, start)):
        k = max(gaps, key=gaps.get)
        out[f"worst_{name}_leaf"] = ["/".join(map(str, k)), gaps[k]]
    return out


def forecast_numbers(got: list, want: list) -> dict:
    """``forecast_gap``: the widest gap between a forecast and the
    reference's, in standard deviations of the scaled feature."""
    gap = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))
    return {"forecast_gap": gap}


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` request indices, drawn from the seed, in order."""
    rng = np.random.default_rng(stream_seed(seed, TRAFFIC + 1))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
