"""Port parity for the serving slice: the port's ``Server`` and
``ServeEngine`` against the JAX package's reference ``Server``.

Both packages serve recurrentgemma-2b's smoke config in float32 with
``use_pallas_scan=True`` (the JAX Pallas scan in interpret mode; the port's
scan kernel takes its plain version on CPU tensors), on the same bridged
parameters.  Greedy tokens must be EQUAL: equal-length prompts that the
engine prefills as one group, a budget-1 request and a request cut off when
its lane's cache fills.  The rest mirrors ``tests/test_serve.py``: one
device→host pull per decode step and per prefill group, router
backpressure and fake-clock deadlines, and a mesh the process group cannot
hold raising (sharded planes: tests/test_torch_serve_mesh.py).
Paged planes and sampled decoding are held to the JAX package in
tests/test_torch_paged.py and tests/test_torch_sampling.py.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models.lm import model as jm
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.models.lm import model as tm
from repro_torch.serve import (Backpressure, InferencePlane, ServeConfig,
                               ServeEngine, Server, count_transfers)
from repro_torch.tree import tree_leaves

SC = dict(slots=3, max_len=40, max_new_tokens=6)
TRUNCATED = 2  # index of the request whose budget outgrows its lane


def _requests():
    """(prompt, budget) pairs: two 8-token and two 12-token prompts (one
    prefill group each in the engine), a budget-1 request, a 5-token one."""
    rng = np.random.default_rng(0)
    lens_budgets = [(8, 6), (12, 4), (8, 6), (12, 6), (5, 1), (5, 3)]
    return [(rng.integers(0, 128, n).astype(np.int32), b) for n, b in lens_budgets]


def _serve(srv, requests, queue):
    """Submit every request, lift one budget past what its lane can hold
    (submit validation refuses such a request, so the test raises it
    afterwards, as tests/test_serve.py does), and drain."""
    rids = [srv.submit(p, max_new_tokens=b) for p, b in requests]
    queue(srv)[TRUNCATED].budget = 100
    out = srv.run()
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module")
def rg():
    jcfg = dataclasses.replace(jax_get_arch("recurrentgemma-2b").smoke_config(),
                               use_pallas_scan=True)
    tcfg = dataclasses.replace(get_arch("recurrentgemma-2b").smoke_config(),
                               use_pallas_scan=True)
    jparams = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_jax(jax.device_get(jparams), device="cpu")
    want = _serve(JaxServer(jparams, jcfg, JaxServeConfig(**SC)), _requests(),
                  lambda s: s.queue)
    return tcfg, tparams, want


def _engine(tcfg, tparams, **kw):
    return ServeEngine(tparams, tcfg, ServeConfig(**SC), device="cpu", **kw)


def test_jax_reference_covers_the_cases(rg):
    _, _, want = rg
    assert len(want[4]) == 1  # budget 1: the prefill token only
    # cut off when the lane's cache filled: 8 prompt tokens + 31 decoded
    assert len(want[TRUNCATED]) == SC["max_len"] - 1 - 8 + 1


def test_server_tokens_equal_the_jax_server(rg):
    tcfg, tparams, want = rg
    srv = Server(tparams, tcfg, ServeConfig(**SC), device="cpu")
    assert _serve(srv, _requests(), lambda s: s.queue) == want


@pytest.mark.parametrize("planes", [1, 2])
def test_engine_tokens_equal_the_jax_server(rg, planes):
    tcfg, tparams, want = rg
    eng = _engine(tcfg, tparams, planes=planes)
    got = _serve(eng, _requests(), lambda e: e.router.queue)
    assert got == want
    statuses = [eng.router.done[rid].status for rid in sorted(eng.router.done)]
    assert statuses == ["ok", "ok", "truncated", "ok", "ok", "ok"]


def test_engine_planes_share_one_set_of_weights(rg):
    tcfg, tparams, _ = rg
    eng = _engine(tcfg, tparams, planes=2)
    a, b = (tree_leaves(p.params) for p in eng.planes)
    assert all(x is y for x, y in zip(a, b))


# ----------------------------------------------------------- sync discipline
def test_server_one_pull_per_decode_step(rg):
    tcfg, tparams, _ = rg
    srv = Server(tparams, tcfg, ServeConfig(slots=3, max_len=40, max_new_tokens=8),
                 device="cpu")
    for p, _ in _requests()[:3]:
        srv.submit(p)
    with count_transfers() as c:
        srv.step()  # 3 single-lane prefills + 1 decode
    assert c["pulls"] == 4
    with count_transfers() as c:
        srv.step()  # steady state: all lanes live
    assert c["pulls"] == 1


def test_engine_one_pull_per_prefill_group_and_decode_step(rg):
    tcfg, tparams, _ = rg
    eng = ServeEngine(tparams, tcfg, ServeConfig(slots=3, max_len=40, max_new_tokens=8),
                      device="cpu")
    for _ in range(3):
        eng.submit(np.array([3, 1, 4, 1, 5], np.int32))
    with count_transfers() as c:
        eng.step()  # 1 batched prefill + 1 decode
    assert c["pulls"] == 2
    with count_transfers() as c:
        eng.step()
    assert c["pulls"] == 1


# ------------------------------------------------------------- router policy
def test_router_backpressure_and_fake_clock_deadlines(rg):
    tcfg, tparams, _ = rg
    now = [0.0]
    eng = ServeEngine(tparams, tcfg, ServeConfig(slots=1, max_len=40, max_new_tokens=3),
                      queue_limit=2, clock=lambda: now[0], device="cpu")
    live = eng.submit(np.array([1, 2, 3], np.int32), deadline_s=5.0)
    queued = eng.submit(np.array([4, 5, 6], np.int32), deadline_s=1.0)
    with pytest.raises(Backpressure):
        eng.submit(np.array([7], np.int32))
    eng.step()  # one lane: the first request runs, the second waits
    assert eng.router.done == {} and len(eng.router.queue) == 1
    now[0] = 2.0  # the queued request expires before it reaches a lane
    eng.step()
    assert eng.router.done[queued].status == "timeout"
    assert eng.router.done[queued].out == []
    now[0] = 6.0  # the live lane is released at its deadline
    eng.run()
    assert eng.router.done[live].status in ("timeout", "ok")
    assert all(r.latency_s is not None for r in eng.router.done.values())


def test_pop_group_takes_same_length_prompts(rg):
    tcfg, tparams, _ = rg
    eng = _engine(tcfg, tparams)
    for n in (4, 6, 4, 4):
        eng.submit(np.arange(1, n + 1, dtype=np.int32))
    group = eng.router.pop_group(3, 512)
    assert [r.prompt.size for r in group] == [4, 4, 4]
    assert [r.rid for r in group] == [0, 2, 3]


# ---------------------------------------------------- not served, and device
def test_mesh_planes_raise(rg):
    """A negative temperature raises; so does a mesh whose slot count is not
    the process group's world (here a group of one process), and a mesh
    with no group at all: a plane asked for a mesh never serves unsharded."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import MeshSpec

    tcfg, tparams, _ = rg
    with pytest.raises(ValueError, match="temperature"):
        ServeConfig(temperature=-1.0)
    two = MeshSpec(("data", "model"), (2, 1))
    with pytest.raises(ValueError, match="none is initialised"):
        InferencePlane(tparams, tcfg, ServeConfig(**SC), mesh=two, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        for make in (InferencePlane, ServeEngine):
            with pytest.raises(ValueError, match="needs 2 ranks, the process group has 1"):
                make(tparams, tcfg, ServeConfig(**SC), mesh=two, device="cpu")
    finally:
        dist.destroy_process_group()


def test_entry_points_default_to_cuda_and_raise_without_it(rg, monkeypatch):
    tcfg, tparams, _ = rg
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: Server(tparams, tcfg, ServeConfig(**SC)),
                 lambda: ServeEngine(tparams, tcfg, ServeConfig(**SC)),
                 lambda: InferencePlane(tparams, tcfg, ServeConfig(**SC)),
                 lambda: tm.init(torch.Generator(), tcfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
