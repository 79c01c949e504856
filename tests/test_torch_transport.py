"""Heartbeat transports of the port, held against the JAX package: twins of
tests/test_transport.py.

The same call sequence into both packages' transports gives the same
``step_feed`` events and ``snapshot`` steps: only beats emitted SINCE THE
LAST POLL are reported (a dead worker's stale file must never refresh its
liveness), a re-announced step counts, beats that predate the poller do
not, torn files are skipped.  Each package reads the other's beat files and
TCP beats (one wire format).  The failover list mirrors beats to the
standby and emitters fail over to it.  End to end, a pipeline whose beats
go through real ``hb_<rank>.json`` files shrinks and grows exactly as the
JAX package's does.
"""
import json
import os
import socket
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.distributed.transport as jt
import repro_torch.distributed.transport as tt
from repro.core import Placement as JPlacement
from repro.core import WindowSpec as JWindowSpec
from repro.data import make_traffic_series
from repro.launch.mesh import make_host_mesh
from repro.optim import AdamConfig as JAdam
from repro.pipeline import ElasticConfig as JElasticConfig
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import Placement, WindowSpec
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import ElasticConfig, PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig

PACKAGES = {"jax": jt, "torch": tt}


def _file_trace(mod, d):
    """One script of emits and polls; what each poll reported."""
    t = mod.FileHeartbeatTransport(d)
    out = []
    t.emit(0, 5)
    t.emit(1, 5, step_time=0.25)
    out.append(t.step_feed(5, 2))
    out.append(t.step_feed(6, 2))      # nothing new: stale ≠ alive
    t.emit(0, 6)
    out.append(t.step_feed(6, 2))
    t.emit(0, 6)                       # the same step again is a fresh beat
    out.append(t.step_feed(7, 2))
    t.emit(7, 3)                       # an outsider: a returned worker
    out.append(t.step_feed(8, 2))
    with open(os.path.join(d, "hb_1.json"), "w") as f:
        f.write('{"rank": 1, "st')     # torn mid-write
    t.emit(0, 9)
    out.append(t.step_feed(9, 2))
    out.append({r: b["step"] for r, b in t.snapshot().items()})
    return out


def test_file_transport_reports_what_jax_reports(tmp_path):
    ours = _file_trace(tt, str(tmp_path / "t"))
    assert ours == _file_trace(jt, str(tmp_path / "j"))
    assert ours[:3] == [{0: (5, None), 1: (5, 0.25)}, {}, {0: (6, None)}]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_each_package_reads_the_others_beats(tmp_path, writer, reader):
    monitor = PACKAGES[reader].FileHeartbeatTransport(str(tmp_path))
    worker = PACKAGES[writer].FileHeartbeatTransport(str(tmp_path))
    worker.emit(0, 3)
    worker.emit(7, 3, step_time=0.5)
    assert monitor.step_feed(3, 2) == {0: (3, None), 7: (3, 0.5)}
    assert monitor.step_feed(4, 2) == {}
    snap = monitor.snapshot()
    assert snap[0]["step"] == 3 and 0 <= snap[0]["age"] < 5.0


def test_file_transport_ignores_beats_predating_the_poller(tmp_path):
    before = tt.FileHeartbeatTransport(str(tmp_path))
    before.emit(1, 7)
    relaunched = tt.FileHeartbeatTransport(str(tmp_path))
    assert relaunched.step_feed(8, 1) == {}
    before.emit(1, 0)
    assert relaunched.step_feed(9, 1) == {1: (0, None)}


@settings(max_examples=25, deadline=None)
@given(seqs=st.lists(st.integers(1, 5), min_size=1, max_size=8))
def test_seq_gate_matches_jax(seqs):
    """The freshness gate is "seq CHANGED since the last poll", in both."""
    traces = {}
    for name, mod in PACKAGES.items():
        t = mod.FileHeartbeatTransport(tempfile.mkdtemp())
        trace = []
        for i, seq in enumerate(seqs):
            with open(os.path.join(t.dir, "hb_0.json"), "w") as f:
                json.dump({"rank": 0, "step": i, "seq": seq, "step_time": None,
                           "wall": time.time()}, f)
            trace.append((t.step_feed(i, 1), t.step_feed(i, 1)))
        traces[name] = trace
    assert traces["torch"] == traces["jax"]


@settings(max_examples=25, deadline=None)
@given(cut=st.integers(0, 70), step=st.integers(0, 99))
def test_torn_write_fuzz_matches_jax(cut, step):
    payload = json.dumps({"rank": 0, "step": step, "seq": 1, "step_time": None,
                          "wall": time.time()})
    traces = {}
    for name, mod in PACKAGES.items():
        t = mod.FileHeartbeatTransport(tempfile.mkdtemp())
        t.emit(1, step)
        with open(os.path.join(t.dir, "hb_0.json"), "w") as f:
            f.write(payload[:min(cut, len(payload) - 1)])
        first = t.step_feed(step, 2)
        seen = sorted(t.snapshot())
        with open(os.path.join(t.dir, "hb_0.json"), "w") as f:
            f.write(payload)
        traces[name] = (first, seen, t.step_feed(step, 2))
    assert traces["torch"] == traces["jax"]
    assert traces["torch"] == ({1: (step, None)}, [1], {0: (step, None)})


# -------------------------------------------------------------- tcp transport
def _poll_until(fn, want, *, timeout=10.0):
    deadline = time.time() + timeout
    acc = {}
    while time.time() < deadline and set(acc) != want:
        acc.update(fn())
        time.sleep(0.01)
    return acc


@pytest.mark.parametrize("emitter,collector", [("jax", "torch"), ("torch", "jax"),
                                               ("torch", "torch")])
def test_tcp_round_trip_across_packages(emitter, collector):
    coll = PACKAGES[collector].TcpHeartbeatCollector(port=0)
    try:
        em = PACKAGES[emitter].TcpHeartbeatEmitter(coll.address)
        em.emit(1, 4, step_time=0.5)
        assert _poll_until(lambda: coll.step_feed(4, 2), {1}) == {1: (4, 0.5)}
        coll.emit(0, 4)  # the collector's own ranks, without dialling
        assert coll.step_feed(4, 2) == {0: (4, None)}
        assert coll.step_feed(5, 2) == {}
        em.close()
    finally:
        coll.close()


def test_tcp_emitter_survives_a_dead_collector():
    coll = tt.TcpHeartbeatCollector(port=0)
    addr = coll.address
    coll.close()
    em = tt.TcpHeartbeatEmitter(addr)
    em.emit(0, 1)  # fire-and-forget: no exception
    em.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_make_transport_and_the_failover_grammar(tmp_path):
    assert isinstance(tt.make_transport(f"file:{tmp_path}"), tt.FileHeartbeatTransport)
    for spec in ("tcp://a:1,b:2", "tcp://h:9", "file:/x"):
        assert tt.tcp_addresses(spec) == jt.tcp_addresses(spec)
    with pytest.raises(ValueError, match="heartbeat transport"):
        tt.make_transport("carrier-pigeon:/loft")
    with pytest.raises(ValueError, match="serve_index 2"):
        tt.make_transport("tcp://127.0.0.1:0,127.0.0.1:0", serve=True, serve_index=2)


def test_tcp_failover_list_mirrors_and_fails_over():
    """Collectors of one failover list mirror beats (the standby holds what
    only the primary was sent); when the primary dies, emitters fail over
    to the standby.  The standby is the JAX package's: one wire format."""
    spec = f"tcp://127.0.0.1:{_free_port()},127.0.0.1:{_free_port()}"
    primary = tt.make_transport(spec, serve=True, serve_index=0)
    standby = jt.make_transport(spec, serve=True, serve_index=1)
    em = tt.make_transport(spec)
    try:
        assert isinstance(em, tt.TcpHeartbeatEmitter)
        em.emit(2, 5, step_time=0.1)
        primary.emit(0, 5)
        for coll in (primary, standby):
            assert _poll_until(lambda: coll.step_feed(5, 3), {0, 2}) == \
                {0: (5, None), 2: (5, 0.1)}
        assert standby.snapshot()[2]["step"] == 5
        primary.close()
        acc, step = {}, 6
        deadline = time.time() + 15
        while time.time() < deadline and 2 not in acc:
            em.emit(2, step)
            step += 1
            acc.update(standby.step_feed(step, 3))
            time.sleep(0.02)
        assert 2 in acc
    finally:
        em.close()
        standby.close()
        primary.close()


# --------------------------------------------- end to end through the engine
def _run_through_files(tmp_path, jax_side: bool):
    """Rank 1 stops writing beats at step 3 (the fake clock then jumps past
    the timeout); from step 6 a rank outside the shrunk world beats."""
    world, b = 4, 2
    mod = jt if jax_side else tt
    transport = mod.FileHeartbeatTransport(str(tmp_path / "hb"))
    clock, killed, pipe = [0.0], [False], []

    def emitter(step: int) -> None:
        clock[0] += 1.0
        current = pipe[0].world
        if current == world and step >= 3 and not killed[0]:
            live = [r for r in range(world) if r != 1]
            clock[0] += 100.0
            killed[0] = True
        elif current < world:
            live = list(range(current)) + ([current] if step >= 6 else [])
        else:
            live = list(range(world))
        for r in live:
            transport.emit(r, step)

    series = make_traffic_series(120, 3)
    kw = dict(heartbeat_timeout=50.0, clock=lambda: clock[0], emitter=emitter,
              step_feed=transport.step_feed)
    if jax_side:
        pipe.append(jax_build_pipeline(
            series, JWindowSpec(horizon=2, input_len=2), make_host_mesh(),
            lambda p, x, y: (jnp.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}),
            {"w": np.full((3, 2), 0.1, np.float32)},
            JPipelineConfig(batch_per_rank=b, placement=JPlacement.REPLICATED, world=world,
                            seed=7, adam=JAdam(lr=1e-2),
                            loop=JLoop(epochs=2, log_every=1, ckpt_dir=str(tmp_path / "ck"))),
            elastic=JElasticConfig(**kw)))
    else:
        pipe.append(build_pipeline(
            series, WindowSpec(horizon=2, input_len=2),
            lambda p, x, y: (torch.mean((x[:, -1] * p["w"] - y[:, 0]) ** 2), {}),
            {"w": torch.full((3, 2), 0.1)},
            PipelineConfig(batch_per_rank=b, placement=Placement.REPLICATED, world=world,
                           seed=7, adam=AdamConfig(lr=1e-2), device="cpu",
                           loop=TrainLoopConfig(epochs=2, log_every=1,
                                                ckpt_dir=str(tmp_path / "ck"))),
            elastic=ElasticConfig(**kw)))
    _, history = pipe[0].fit(eval_fn=None)
    records = [(r["kind"], r["epoch"], r["step"], r["world"], r["batch_per_rank"],
                r["plan"].dropped_workers, r["plan"].readmitted_workers)
               for r in pipe[0].restarts]
    return (records, [h["step"] for h in history if "epoch_time_s" not in h], pipe[0].world,
            sorted(transport.snapshot()))


def test_pipeline_shrinks_and_grows_through_file_transport(tmp_path):
    ours = _run_through_files(tmp_path / "t", jax_side=False)
    assert ours == _run_through_files(tmp_path / "j", jax_side=True)
    records, steps, world, ranks = ours
    assert [r[0] for r in records] == ["shrink", "grow"] and records[0][5] == (1,)
    assert world == 4 and set(ranks) >= {0, 1, 2}
    assert steps == sorted(steps) and len(steps) == len(set(steps))
