"""The benchmark's model FLOPs equal ``FlopCounterMode`` over the frozen
reference's forward, and forward and backward in training; the traffic
generator and the trace reduction on small cases."""
import importlib
import types

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench import trace
from bench.harness import BENCH, load_json
from bench.inputs import batches, make_params, stream_seed
from bench.check import reference_model

CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def _small(name):
    cfg = load_json(BENCH / "configs" / f"{name}.json")
    # PGT-DCRNN forecasts a step per input step, so its horizon is its input
    horizon = 5 if cfg["reference"] == "pgt_dcrnn" else 4
    return {**cfg, "num_nodes": 9, "input_len": 5, "horizon": horizon}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("train", [False, True])
def test_flops_equal_flop_counter(name, train):
    cfg = _small(name)
    model = reference_model(cfg)
    counts = importlib.import_module(f"bench.counts.{cfg['reference']}")
    params = make_params(model.param_specs(cfg), 3, "cpu")
    leaves = []

    def grad_leaves(tree):
        for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
            if isinstance(v, torch.Tensor):
                tree[k] = v.clone().requires_grad_(train)
                leaves.append(tree[k])
            else:
                grad_leaves(v)
    grad_leaves(params)
    n, b = cfg["num_nodes"], 3
    supports = model.graph(torch.rand(n, n))
    x = torch.randn(b, cfg["input_len"], n, cfg["in_features"])
    y = torch.randn(b, cfg["horizon"], n, cfg["in_features"])
    with FlopCounterMode(display=False) as counter:
        if train:
            model.loss(params, cfg, supports, x, y, torch.mm).backward()
        else:
            with torch.no_grad():
                model.forward(params, cfg, supports, x, torch.mm)
    assert counter.get_total_flops() == counts.flops(cfg, b, train=train)


@pytest.mark.parametrize("name", CONFIGS)
def test_hop_shapes_cover_every_hop(name):
    cfg = _small(name)
    counts = importlib.import_module(f"bench.counts.{cfg['reference']}")
    shapes = counts.hop_shapes(cfg, 2)
    hops = sum(2 * n * n * b * c for n, b, c, _ in shapes)
    # the forward's hop products are its FLOPs less the projections
    assert 0 < hops < counts.flops(cfg, 2, train=False)
    assert len(shapes) % (2 * cfg["max_diffusion_step"]) == 0


def test_batches_repeat_per_seed_and_do_not_repeat_windows():
    ids = np.arange(100)
    a = [next(g) for g in [batches(ids, 8, 5)] for _ in range(12)]
    b = [next(g) for g in [batches(ids, 8, 5)] for _ in range(12)]
    c = [next(g) for g in [batches(ids, 8, 2 ** 33 + 1)] for _ in range(12)]
    assert all((x == y).all() for x, y in zip(a, b))
    assert not all((x == y).all() for x, y in zip(a, c))
    assert len(np.unique(np.concatenate(a))) == 96
    assert stream_seed(1, 0) != stream_seed(1, 1) != stream_seed(2, 1)


def _event(name, start, end, cuda=False, corr=0, linked=0):
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: end - start,
        device_type=lambda: dev, correlation_id=lambda: corr,
        linked_correlation_id=lambda: linked, is_async=lambda: False,
        is_user_annotation=lambda: False)


def test_trace_summary_busy_kernels_and_gaps():
    events = [_event("bench.train_step", 0, 1000), _event("aten::mm", 100, 200, corr=7),
              _event("aten::add", 500, 600, corr=8),
              _event("gemm_kernel", 150, 400, cuda=True, linked=7),
              _event("add_kernel", 300, 450, cuda=True, linked=8),
              _event("add_kernel", 700, 800, cuda=True, linked=8)]
    s = trace.summarize(events, window_s=1e-6)
    assert s.busy_s == pytest.approx(400e-9)
    assert s.kernel_time("add") == (2, pytest.approx(250e-9))
    assert s.kernel_time("gemm") == (1, pytest.approx(250e-9))
    assert s.idle_by_host == {"train_step:aten::add": pytest.approx(250e-9)}
    assert s.breakdown()["device_ops"][0][0] == "gemm_kernel"
