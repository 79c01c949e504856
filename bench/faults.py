"""Faults planted under the timed path, to show that the check catches
them: in the program for the tests (around ``bench.program.Program``'s
model calls, or in ``repro_torch``), or in the reference put in its place
for the readings on the chip (``bench/calibrate.py``). The benchmark's own
runs plant none.
"""
from __future__ import annotations

import contextlib
import importlib

from bench.program import Program

#: The alteration of an answer, in standard deviations of the scaled feature.
ALTERATION = 1e-2


@contextlib.contextmanager
def _patched(owner, name: str, replacement):
    original = getattr(owner, name)
    setattr(owner, name, replacement(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def frozen_state():
    """The train step returns the state it was given (its loss as computed)."""
    engine = importlib.import_module("repro_torch.pipeline.engine")

    def wrap(make_train_step):
        def make(*args, **kwargs):
            inner = make_train_step(*args, **kwargs)

            def step(state, batch):
                return state, inner(state, batch)[1]
            return step
        return make
    return _patched(engine, "make_train_step", wrap)


def half_batch():
    """The program's loss leaves out the second half of each batch and
    takes the mean over the rest."""
    def wrap(loss):
        def half(self, params, x, y):
            keep = max(x.shape[0] // 2, 1)
            return loss(self, params, x[:keep], y[:keep])
        return half
    return _patched(Program, "loss", wrap)


def scaled_gradient(factor: float = 2.0):
    """The program's backward is off by a constant ``factor`` on every leaf
    (as a sum taken for a mean would be); the loss's value is unchanged."""
    def wrap(loss):
        def scaled(self, params, x, y):
            value = loss(self, params, x, y)
            return factor * value - (factor - 1.0) * value.detach()
        return scaled
    return _patched(Program, "loss", wrap)


def half_batch_reference(config: dict):
    """Half of each batch left out in the reference put in the program's
    place (its ``loss(params, config, graph, x, y, mm)``)."""
    module = importlib.import_module(f"bench.models.{config['reference']}")

    def wrap(loss):
        def half(params, cfg, graph, x, y, *rest):
            keep = max(x.shape[0] // 2, 1)
            return loss(params, cfg, graph, x[:keep], y[:keep], *rest)
        return half
    return _patched(module, "loss", wrap)


def altered_answer():
    """Every forecast the program's model produces has one value moved by
    :data:`ALTERATION`."""
    def wrap(apply):
        def altered(self, params, x):
            out = apply(self, params, x)
            out[0, -1, 0, 0] += ALTERATION
            return out
        return altered
    return _patched(Program, "apply", wrap)
