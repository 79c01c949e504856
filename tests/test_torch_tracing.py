"""The port's spans (``repro_torch.tracing``): under ``torch.profiler`` a
train step opens ``starts``, ``forward`` (with ``gather`` inside it),
``backward`` and ``optimizer`` once each, in that order; with no profiler
active a span opens no ``record_function`` at all."""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import WindowSpec
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train.loop import init_train_state

ADAM = AdamConfig(lr=1e-2, grad_clip=1.0)
BATCH = 4


def _loss(p, x, y):
    return ((x.mean(1) * p["w"]).sum(-1) - y.mean(1)[..., 0]).square().mean(), {}


@pytest.fixture
def engine():
    series = np.random.default_rng(0).standard_normal((120, 5, 2)).astype(np.float32)
    params = {"w": torch.ones(2)}
    eng = build_pipeline(series, WindowSpec(horizon=3, input_len=4), _loss, params,
                         PipelineConfig(batch_per_rank=BATCH, gather="pallas", seed=1,
                                        device="cpu", adam=ADAM))
    return eng, init_train_state(params, ADAM)


def _steps(eng, state, n=2):
    for i in range(n):
        state, _ = eng.train_step(state, eng.batch_of_starts(np.arange(BATCH) + BATCH * i))
    return state


def test_each_span_once_a_step_in_order(engine):
    eng, state = engine
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _steps(eng, state)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                    e.name()[len(tracing.PREFIX):])
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(tracing.PREFIX))
    assert Counter(name for *_, name in spans) == \
        {"starts": 2, "gather": 2, "forward": 2, "backward": 2, "optimizer": 2}
    assert [name for *_, name in spans] == \
        ["starts", "forward", "gather", "backward", "optimizer"] * 2
    forwards = [(s, e) for s, e, name in spans if name == "forward"]
    for s, e, name in spans:
        if name == "gather":
            assert any(fs <= s and e <= fe for fs, fe in forwards)


def test_no_record_function_without_a_profiler(engine, monkeypatch):
    eng, state = engine
    opened = []
    real = torch.profiler.record_function

    def counting(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert tracing.span("forward") is tracing.span("backward")
    _steps(eng, state)
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        _steps(eng, state, n=1)
    assert sorted(opened) == sorted(tracing.PREFIX + n for n in
                                    ("starts", "forward", "gather", "backward", "optimizer"))
