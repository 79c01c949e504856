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
from bench.inputs import batches, leaves, make_params, stream_seed
from bench.check import reference_model

CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def _small(name):
    """The configuration at 9 nodes, 5 input steps and a horizon of 4, then
    its own ``cpu`` overrides."""
    cfg = load_json(BENCH / "configs" / f"{name}.json")
    # PGT-DCRNN forecasts a step per input step, so its horizon is its input
    horizon = 5 if cfg["reference"] == "pgt_dcrnn" else 4
    return {**cfg, "num_nodes": 9, "input_len": 5, "horizon": horizon, **cfg.get("cpu", {})}


def _counts(name):
    return importlib.import_module(f"bench.counts.{_small(name)['reference']}")


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


class _Product(torch.autograd.Function):
    """``torch.mm`` that logs each hop (an ``[n, n]`` left operand) it runs
    forward, and backward into its right operand."""

    log: dict = {}

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.shape[0] == a.shape[1] == _Product.log["n"]:
            _Product.log["forward"].append(tuple(b.shape))
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if ctx.needs_input_grad[1] and a.shape[0] == a.shape[1] == _Product.log["n"]:
            _Product.log["backward"].append(tuple(b.shape))
        return (g @ b.T if ctx.needs_input_grad[0] else None,
                a.T @ g if ctx.needs_input_grad[1] else None)


@pytest.mark.parametrize("name", [n for n in CONFIGS if hasattr(_counts(n), "hop_shapes")])
def test_hop_shapes_cover_every_hop(name):
    cfg = _small(name)
    counts = _counts(name)
    shapes = counts.hop_shapes(cfg, 2)
    hops = sum(2 * n * n * b * c for n, b, c, _ in shapes)
    # the forward's hop products are its FLOPs less the projections
    assert 0 < hops < counts.flops(cfg, 2, train=False)
    assert len(shapes) % (2 * cfg["max_diffusion_step"]) == 0
    # the hops the reference runs, forward and backward into Z, are those counted
    model, n = reference_model(cfg), cfg["num_nodes"]
    params = make_params(model.param_specs(cfg), 3, "cpu")
    for p in leaves(params).values():
        p.requires_grad_(True)
    _Product.log = {"n": n, "forward": [], "backward": []}
    x = torch.randn(2, cfg["input_len"], n, cfg["in_features"])
    y = torch.randn(2, cfg["horizon"], n, cfg["in_features"])
    model.loss(params, cfg, model.graph(torch.rand(n, n)), x, y, _Product.apply).backward()
    for got, want in ((_Product.log["forward"], shapes),
                      (_Product.log["backward"], counts.backward_hop_shapes(cfg, 2))):
        assert sorted(got) == sorted((n, b * c) for n, b, c, _ in want)


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


def test_trace_summary_gives_device_ops_to_the_span_of_their_launch():
    """Program spans nest (``gather`` in ``forward``); a kernel belongs to
    the innermost span open at the runtime call that launched it (same
    correlation id), whether an op launched it, ctypes did (no op), or
    autograd's thread did; gaps go to the span open at their midpoint."""
    events = [_event("bench.train_step", 0, 1000), _event("repro_torch.starts", 5, 30),
              _event("repro_torch.forward", 40, 400), _event("repro_torch.gather", 50, 120),
              _event("repro_torch.backward", 400, 900),
              # an op inside gather, its launch, its kernel
              _event("aten::index", 60, 110, corr=7),
              _event("cudaLaunchKernel", 70, 80, corr=101, linked=7),
              _event("gather_kernel", 100, 200, cuda=True, corr=101, linked=7),
              # a ctypes launch in forward, outside every op
              _event("cuLaunchKernel", 150, 160, corr=102),
              _event("hop_gemm_kernel", 250, 450, cuda=True, corr=102),
              # autograd's thread, in the caller's backward span
              _event("aten::mm", 500, 540, corr=8),
              _event("cudaLaunchKernel", 510, 520, corr=103, linked=8),
              _event("gemm_kernel", 600, 700, cuda=True, corr=103, linked=8),
              # the starts' copy, launched in starts; no launch found for the last
              _event("cudaMemcpyAsync", 10, 20, corr=104),
              _event("Memcpy HtoD", 20, 25, cuda=True, corr=104),
              _event("stray_kernel", 800, 850, cuda=True, corr=999)]
    s = trace.summarize(events, window_s=1e-6)
    # what today's reduction reads of the same events
    assert s.busy_s == pytest.approx(455e-9)
    assert s.kernels == {"gather_kernel": [1, pytest.approx(100e-9)],
                         "hop_gemm_kernel": [1, pytest.approx(200e-9)],
                         "gemm_kernel": [1, pytest.approx(100e-9)],
                         "Memcpy HtoD": [1, pytest.approx(5e-9)],
                         "stray_kernel": [1, pytest.approx(50e-9)]}
    assert s.idle_by_host == {"train_step:aten::index": pytest.approx(75e-9),
                              "train_step:repro_torch.forward": pytest.approx(50e-9),
                              "train_step:aten::mm": pytest.approx(150e-9),
                              "train_step:repro_torch.backward": pytest.approx(100e-9)}
    assert s.span_device_s == {"starts": pytest.approx(5e-9), "forward": pytest.approx(200e-9),
                               "gather": pytest.approx(100e-9),
                               "backward": pytest.approx(100e-9)}
    assert s.unlaunched_s == pytest.approx(50e-9)
    assert s.span_idle_s == {"starts": 0.0, "forward": pytest.approx(50e-9),
                             "gather": pytest.approx(75e-9), "backward": pytest.approx(250e-9)}
    assert s.span_ms("span_device_s", "forward", 2) == pytest.approx(1e-4)
    assert s.span_ms("span_idle_s", "optimizer", 2) is None
