"""Distributed-index-batching in the port, held against the JAX package.

- ``local_time_range``, ``local_window_ids`` and the three samplers
  (``GlobalShuffleSampler``, ``LocalBatchShuffleSampler`` with
  ``local_shuffle_sampler``, ``ShardAlignedBatchSampler``) give bit-equal
  feeds, ``epoch_global`` and eval feeds over a grid of world, batch, seed,
  epoch and halo, and fall back from aligned to count-split in the same
  cases;
- the single-process lock-step plane (``PipelineConfig(world=2)`` and
  ``world=4``) of every placement: ``describe()``, feeds and
  ``epoch_global`` equal to JAX's ``build_pipeline`` with the same world,
  ``fit`` losses and ``evaluate`` within rtol 1e-4;
- a rank's resident rows, rebased starts gathered from them bit-equal to
  ``window_gather_ref`` over the whole series, and a start outside them
  raising;
- a 2-process gloo run on the CPU (``torch.multiprocessing`` spawn) under
  every placement: global losses within rtol 1e-4 of JAX's world-2 run,
  ``ONDEMAND`` bit-equal to ``REPLICATED``, resident rows as the JAX
  samplers' domains predict, one val loss on both ranks, and a resume from
  rank 0's checkpoint bit-identical to the uninterrupted run; world 4 over
  the same two processes (two feed ranks each), and over four processes,
  held against JAX's world-4 run the same way.

The JAX side gathers with ``slice`` (its plain gather, bit-identical to its
Pallas one); the port with ``pallas``, which on CPU tensors takes the
kernel's plain version.  Tolerance: rtol 1e-4, as tests/test_torch_pipeline.py
(the port's data-parallel mean is taken per rank and then averaged, where
the JAX lock-step plane takes it over the whole global batch at once).
"""
import dataclasses
import json
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.core import WindowSpec as JWindowSpec
from repro.core import distributed as jdist
from repro.core import sampler as jsampler
from repro.core.index_dataset import IndexDataset as JIndexDataset
from repro.data import (gaussian_adjacency, make_traffic_series,
                        random_sensor_coords, transition_matrices)
from repro.launch.mesh import make_host_mesh
from repro.models import pgt_dcrnn as jm
from repro.optim import AdamConfig as JAdam
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.pipeline import dataplane as jdataplane
from repro.pipeline import samplers as jsamplers
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import IndexDataset, Placement, WindowSpec
from repro_torch.core import distributed as tdist
from repro_torch.core import sampler as tsampler
from repro_torch.core.windows import split_windows
from repro_torch.distributed import Checkpointer
from repro_torch.interop import params_from_jax
from repro_torch.kernels.window_gather import window_gather_ref
from repro_torch.models import pgt_dcrnn as tm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.pipeline import dataplane as tdataplane
from repro_torch.pipeline import samplers as tsamplers
from repro_torch.train import TrainLoopConfig

NODES, ENTRIES, HORIZON, BATCH, HIDDEN, LR, SEED = 8, 240, 3, 4, 8, 5e-3, 3
SPAN = 2 * HORIZON
RTOL = 1e-4
PLACEMENTS = [p.value for p in Placement]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The steps are far too small to share among threads, and the tier-1
    run puts several test workers on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------- index math
@pytest.mark.parametrize("entries", [7, 100, 101, 240])
@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("halo", [True, False])
def test_local_time_range_and_window_ids_bit_equal(entries, world, halo):
    spec, jspec = WindowSpec(horizon=3), JWindowSpec(horizon=3)
    for r in range(world):
        assert tdist.local_time_range(entries, r, world) == \
            jdist.local_time_range(entries, r, world)
        ours = tdist.local_window_ids(entries, spec, r, world, halo=halo)
        theirs = jdist.local_window_ids(entries, jspec, r, world, halo=halo)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def _feeds(s, world, epochs=(0, 1, 5)):
    return {(r, e): s.feed(r, e) for r in range(world) for e in epochs}


def _assert_samplers_equal(ours, theirs, world, pool):
    assert ours.steps_per_epoch == theirs.steps_per_epoch
    a, b = _feeds(ours, world), _feeds(theirs, world)
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    for e in (0, 3):
        assert np.array_equal(ours.epoch_global(e), theirs.epoch_global(e))
    for r in range(world):
        assert np.array_equal(ours.eval_feed(r, pool), theirs.eval_feed(r, pool))
    assert np.array_equal(ours.eval_tail(pool), theirs.eval_tail(pool))
    assert np.array_equal(ours.eval_global(pool), theirs.eval_global(pool))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("seed", [0, 5])
def test_count_split_and_global_samplers_bit_equal(world, batch, seed):
    tr, va, _ = split_windows(493, 0.7, 0.1)
    for make in ("GlobalShuffleSampler", "LocalBatchShuffleSampler",
                 "local_shuffle_sampler"):
        ours = getattr(tsampler, make)(tr, batch, tsampler.ShardInfo(0, world), seed=seed)
        theirs = getattr(jsampler, make)(tr, batch, jsampler.ShardInfo(0, world),
                                         seed=seed)
        _assert_samplers_equal(ours, theirs, world, va)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("batch", [3, 8])
@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("halo", [True, False])
def test_shard_aligned_sampler_and_its_fallback_bit_equal(world, batch, seed, halo):
    """Aligned where every shard holds a batch of train windows, the same
    ``ValueError`` where one does not, and ``_make_sampler`` falls back to
    the count-split in exactly those cases."""
    raw = make_traffic_series(500, 3)
    spec, jspec = WindowSpec(horizon=4), JWindowSpec(horizon=4)
    ds, jds = IndexDataset.from_raw(raw, spec), JIndexDataset.from_raw(raw, jspec)
    args = (ds.entries, spec, ds.train_windows, batch, world)
    jargs = (jds.entries, jspec, jds.train_windows, batch, world)
    try:
        theirs = jsamplers.ShardAlignedBatchSampler(*jargs, seed=seed, halo=halo)
    except ValueError as e:
        with pytest.raises(ValueError, match="too small for one batch"):
            tsamplers.ShardAlignedBatchSampler(*args, seed=seed, halo=halo)
        assert "too small" in str(e)
    else:
        ours = tsamplers.ShardAlignedBatchSampler(*args, seed=seed, halo=halo)
        _assert_samplers_equal(ours, theirs, world, ds.val_windows)
        assert all(np.array_equal(a, b) for a, b in zip(ours.rank_ids, theirs.rank_ids))
    made = tdataplane._make_sampler(
        PipelineConfig(batch_per_rank=batch, placement=Placement.PARTITIONED,
                       seed=seed, halo=halo), ds, world)
    jmade = jdataplane._make_sampler(
        JPipelineConfig(batch_per_rank=batch, placement=jdist.Placement.PARTITIONED,
                        seed=seed, halo=halo), jds, world)
    assert type(made).__name__ == type(jmade).__name__
    _assert_samplers_equal(made, jmade, world, ds.val_windows)


def test_shard_aligned_sampler_refuses_what_the_reference_refuses():
    spec = WindowSpec(horizon=4, stride=2)
    with pytest.raises(ValueError, match="stride=1"):
        tsamplers.ShardAlignedBatchSampler(100, spec, np.arange(10), 2, 2)
    with pytest.raises(ValueError, match="partition smaller"):
        tsampler.LocalBatchShuffleSampler(np.arange(5), 4, tsampler.ShardInfo(0, 2))


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def setup():
    series = make_traffic_series(ENTRIES, NODES)
    sup = transition_matrices(gaussian_adjacency(random_sensor_coords(NODES)))
    kw = dict(num_nodes=NODES, hidden=HIDDEN, input_len=HORIZON, horizon=HORIZON)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.PGTDCRNNConfig(**kw)))
    return series, sup, kw, jparams


_JAX_RUNS: dict = {}


def jax_run(setup, world, placement, halo=True) -> dict:
    """JAX's single-host lock-step plane with ``world`` ranks: one epoch,
    every step logged, then ``evaluate`` of val and test (cached)."""
    key = (world, placement, halo)
    if key not in _JAX_RUNS:
        series, sup, kw, jparams = setup
        cfg = jm.PGTDCRNNConfig(**kw)
        jsup = tuple(jnp.asarray(s) for s in sup)

        def jloss(p, x, y):
            return jm.loss_fn(p, cfg, jsup, x, y), {}

        pipe = jax_build_pipeline(
            series, JWindowSpec(horizon=HORIZON), make_host_mesh(), jloss, jparams,
            JPipelineConfig(batch_per_rank=BATCH, placement=jdist.Placement(placement),
                            halo=halo, world=world, gather="slice", seed=SEED,
                            adam=JAdam(lr=LR), loop=JLoop(epochs=1, log_every=1)))
        state, hist = pipe.fit()
        _JAX_RUNS[key] = {
            "pipe": pipe,
            "losses": [h["loss"] for h in hist if "epoch_time_s" not in h],
            "val": pipe.evaluate(state["params"], split="val"),
            "test": pipe.evaluate(state["params"], split="test"),
        }
    return _JAX_RUNS[key]


def torch_config(placement, **kw):
    kw.setdefault("loop", TrainLoopConfig(epochs=1, log_every=1))
    return PipelineConfig(batch_per_rank=BATCH, placement=Placement(placement),
                          gather="pallas", seed=SEED, device="cpu",
                          adam=AdamConfig(lr=LR), **kw)


def torch_pipe(series, sup, kw, jparams, config):
    cfg = tm.PGTDCRNNConfig(**kw)
    tsup = tuple(torch.as_tensor(s) for s in sup)

    def loss_fn(p, x, y):
        return tm.loss_fn(p, cfg, tsup, x, y), {}

    return build_pipeline(series, WindowSpec(horizon=HORIZON), loss_fn,
                          params_from_jax(jparams, device="cpu"), config)


def rel(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.max(np.abs(ours - theirs) / np.abs(theirs)))


COMMON = ("sampler", "gather", "world", "global_batch", "halo")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_lockstep_plane_matches_jax(setup, world, placement):
    series, sup, kw, jparams = setup
    ref = jax_run(setup, world, placement)
    jpipe = ref["pipe"]
    pipe = torch_pipe(series, sup, kw, jparams, torch_config(placement, world=world))
    d, jd = pipe.describe(), jpipe.describe()
    assert d["placement"].value == jd["placement"].value == placement
    assert {k: d[k] for k in COMMON} == {k: jd[k] for k in COMMON if k != "gather"} | \
        {"gather": "pallas"}
    # one process holds every row: the lock-step simulation issues no collective
    assert d["resident_rows"] == (0, ENTRIES)
    assert d["resident_bytes"] == ENTRIES * NODES * 2 * 4
    assert pipe.steps_per_epoch == jpipe.steps_per_epoch >= 10
    for e in (0, 1):
        assert np.array_equal(pipe.dataplane.epoch_global(e),
                              jpipe.dataplane.epoch_global(e))
        for r in range(world):
            assert np.array_equal(pipe.dataplane.feed(r, e), jpipe.dataplane.feed(r, e))
    state, hist = pipe.fit()
    losses = [h["loss"] for h in hist if "epoch_time_s" not in h]
    devs = {"loss": rel(losses, ref["losses"])}
    for split in ("val", "test"):
        devs[split] = rel(pipe.evaluate(state["params"], split=split), ref[split])
    assert all(v <= RTOL for v in devs.values()), devs


def test_partitioned_world4_takes_the_count_split_fallback(setup):
    """At world 4 the last shard holds no train window, so both packages
    fall back to the count-split sampler."""
    ref = jax_run(setup, 4, "partitioned")
    assert ref["pipe"].describe()["sampler"] == "LocalBatchShuffleSampler"


# --------------------------------------------------------- resident rows
def _as_process(monkeypatch, process, processes):
    monkeypatch.setattr(tdataplane, "process_info", lambda: (process, processes))


@pytest.mark.parametrize("placement,halo,process,rows", [
    ("replicated", True, 1, (0, ENTRIES)),
    ("ondemand", True, 0, (0, 120)),
    ("ondemand", True, 1, (120, ENTRIES)),
    ("partitioned", True, 0, (0, 120 + SPAN - 1)),
    ("partitioned", False, 0, (0, 120)),
    ("partitioned", True, 1, (120, ENTRIES)),
])
def test_rank_keeps_its_resident_rows_and_gathers_from_them(
        setup, monkeypatch, placement, halo, process, rows):
    series = setup[0]
    _as_process(monkeypatch, process, 2)
    dp = tdataplane.build_dataplane(series, WindowSpec(horizon=HORIZON),
                                    torch_config(placement, halo=halo))
    d = dp.describe()
    assert d["world"] == 2 and dp.process_ranks == [process]
    assert d["resident_rows"] == dp.dataset.resident_rows == rows
    assert d["resident_bytes"] == (rows[1] - rows[0]) * NODES * 2 * 4
    assert dp.dataset.entries == ENTRIES and dp.dataset.origin == rows[0]
    whole = torch.as_tensor(IndexDataset.from_raw(series, WindowSpec(horizon=HORIZON)).series)
    if placement == "ondemand":
        return  # gathered through the exchange: the 2-process run holds it
    ids = dp.epoch_grid(0)[0]
    starts = dp.batch_of_starts(ids)
    got = window_gather_ref(dp.dataset.series, starts, span=SPAN)
    want = window_gather_ref(whole, torch.as_tensor(dp.dataset.starts[ids]), span=SPAN)
    assert starts.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("process", [0, 1])
def test_a_start_outside_the_resident_rows_raises(setup, monkeypatch, process):
    series = setup[0]
    _as_process(monkeypatch, process, 2)
    dp = tdataplane.build_dataplane(series, WindowSpec(horizon=HORIZON),
                                    torch_config("partitioned"))
    lo, hi = dp.dataset.resident_rows
    inside = [lo, hi - SPAN]
    outside = lo - 1 if lo > 0 else hi - SPAN + 1
    assert dp.host_batch_of_starts(np.asarray(inside)).tolist() == [0, hi - lo - SPAN]
    with pytest.raises(ValueError, match="leave the resident rows"):
        dp.batch_of_starts(np.asarray(inside + [outside]))
    # the exchange takes starts anywhere: it masks by owner
    assert dp.host_batch_of_starts(np.asarray([outside]), exchange=True).tolist() == \
        [outside - lo]


# ------------------------------------------------ two and four processes on gloo
CASES = {  # name -> (world, placement, halo)
    "replicated": (2, "replicated", True),
    "partitioned": (2, "partitioned", True),
    "partitioned-no-halo": (2, "partitioned", False),
    "ondemand": (2, "ondemand", True),
    "replicated-world4": (4, "replicated", True),
    "partitioned-world4": (4, "partitioned", True),
    "ondemand-world4": (4, "ondemand", True),
}
# 2 processes run every case (world 4: two feed ranks a process), 4
# processes the world-4 cases (one rank a process)
GROUPS = {2: sorted(CASES), 4: sorted(n for n in CASES if n.endswith("world4"))}
RUNS = [(p, name) for p, names in GROUPS.items() for name in names]
CKPT_EVERY, RESUME_CASE = 4, "partitioned"
# runs through the feed prefetcher (depth 2) on 2 processes
PREFETCH = [(name, s) for name in ("partitioned", "ondemand") for s in (0, 1)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(process, processes, port, work, setup):
    """One process of a gloo run: its group's cases, then (2 processes) a
    resume of RESUME_CASE from its oldest retained checkpoint; results to
    JSON."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=process, world_size=processes)
    try:
        series, sup, kw, jparams = setup
        out = {}
        for name in GROUPS[processes]:
            world, placement, halo = CASES[name]
            ckpt = f"{work}/A" if name == RESUME_CASE else None
            loop = TrainLoopConfig(epochs=1, log_every=1, ckpt_dir=ckpt,
                                   ckpt_every=CKPT_EVERY if ckpt else 0)
            config = torch_config(placement, world=world, halo=halo, loop=loop)
            pipe = torch_pipe(series, sup, kw, jparams, config)
            state, hist = pipe.fit()
            d = pipe.describe()
            out[name] = {"hist": hist, "rows": list(d["resident_rows"]),
                         "sampler": d["sampler"], "ranks": pipe.dataplane.process_ranks,
                         "val": pipe.evaluate(state["params"], split="val"),
                         "test": pipe.evaluate(state["params"], split="test")}
            if ckpt:
                mid = Checkpointer(ckpt).steps()[0]  # the oldest one kept
                if process == 0:
                    shutil.copytree(f"{ckpt}/step_{mid:010d}", f"{work}/B/step_{mid:010d}")
                dist.barrier()
                resumed = torch_pipe(series, sup, kw, jparams, dataclasses.replace(
                    config, loop=dataclasses.replace(loop, ckpt_dir=f"{work}/B")))
                _, hist_b = resumed.fit()
                out["resume"] = {"mid": mid, "hist": hist_b}
        for name, staleness in PREFETCH if processes == 2 else ():
            world, placement, halo = CASES[name]
            loop = TrainLoopConfig(epochs=1, log_every=1, prefetch_depth=2,
                                   staleness=staleness)
            pipe = torch_pipe(series, sup, kw, jparams,
                              torch_config(placement, world=world, halo=halo, loop=loop))
            out[f"{name}-staleness{staleness}"] = pipe.fit()[1]
        with open(f"{work}/process{process}.json", "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_runs(setup, tmp_path_factory):
    """``runs(processes) -> (work dir, [each process's results])``, each
    group spawned once."""
    done = {}

    def runs(processes):
        if processes not in done:
            work = tmp_path_factory.mktemp(f"gloo{processes}")
            mp.spawn(_worker, args=(processes, _free_port(), str(work), setup),
                     nprocs=processes, join=True)
            done[processes] = work, [json.loads((work / f"process{p}.json").read_text())
                                     for p in range(processes)]
        return done[processes]
    return runs


def _steps(hist):
    return [h for h in hist if "epoch_time_s" not in h]


def _no_time(hist):
    return [{k: v for k, v in h.items() if k != "epoch_time_s"} for h in hist]


@pytest.mark.parametrize("processes,name", RUNS)
def test_gloo_losses_match_jax(setup, gloo_runs, processes, name):
    world, placement, halo = CASES[name]
    ref = jax_run(setup, world, placement, halo)
    for run in gloo_runs(processes)[1]:
        losses = [h["loss"] for h in _steps(run[name]["hist"])]
        assert len(losses) == len(ref["losses"]) >= 10
        devs = {"loss": rel(losses, ref["losses"]), "val": rel(run[name]["val"], ref["val"]),
                "test": rel(run[name]["test"], ref["test"])}
        assert all(v <= RTOL for v in devs.values()), (name, devs)


@pytest.mark.parametrize("processes,world", [(2, ""), (2, "-world4"), (4, "-world4")])
def test_gloo_ondemand_is_bit_equal_to_replicated(gloo_runs, processes, world):
    for run in gloo_runs(processes)[1]:
        assert _no_time(run["ondemand" + world]["hist"]) == \
            _no_time(run["replicated" + world]["hist"])
        assert run["ondemand" + world]["val"] == run["replicated" + world]["val"]


def _predicted_rows(setup, world, placement, halo, ranks):
    """Resident rows from the JAX package's own samplers: the hull of each
    owned rank's shard (with the aligned sampler's halo) and of the windows
    its feed can draw."""
    if placement == "replicated":
        return [0, ENTRIES]
    jpipe = jax_run(setup, world, placement, halo)["pipe"]
    spans = []
    for r in ranks:
        lo, hi = jdist.local_time_range(ENTRIES, r, world)
        if placement == "partitioned":
            s = jpipe.sampler
            aligned = hasattr(s, "rank_batches")
            if aligned and halo:  # the next shard's first span - 1 rows
                hi = min(hi + SPAN - 1, ENTRIES)
            ids = (s.rank_batches[r] if aligned else s._rank_batches[r]).reshape(-1)
            starts = jpipe.dataset.starts[ids]
            lo, hi = min(lo, int(starts.min())), max(hi, int(starts.max()) + SPAN)
        spans.append((lo, hi))
    return [min(s[0] for s in spans), max(s[1] for s in spans)]


@pytest.mark.parametrize("processes,name", RUNS)
def test_gloo_resident_rows_as_predicted(setup, gloo_runs, processes, name):
    world, placement, halo = CASES[name]
    for p, run in enumerate(gloo_runs(processes)[1]):
        per = world // processes
        assert run[name]["ranks"] == list(range(p * per, (p + 1) * per))
        assert run[name]["rows"] == _predicted_rows(setup, world, placement, halo,
                                                    run[name]["ranks"])
        if placement != "replicated":
            lo, hi = run[name]["rows"]
            assert hi - lo < ENTRIES  # no rank holds the whole series
        if name == "partitioned-world4":
            assert run[name]["sampler"] == "LocalBatchShuffleSampler"


@pytest.mark.parametrize("processes,name", RUNS)
def test_gloo_val_loss_is_one_number(gloo_runs, processes, name):
    first, *others = (run[name] for run in gloo_runs(processes)[1])
    for other in others:
        assert other["val"] == first["val"] and other["test"] == first["test"]
        assert _no_time(other["hist"]) == _no_time(first["hist"])


def test_gloo_resume_from_rank0_checkpoint_is_bit_identical(gloo_runs):
    work, runs = gloo_runs(2)
    kept = sorted(p.name for p in (work / "A").iterdir() if p.name.startswith("step_"))
    steps = len(_steps(runs[0][RESUME_CASE]["hist"]))
    assert kept == [f"step_{s:010d}" for s in (steps - steps % CKPT_EVERY - CKPT_EVERY,
                                                steps - steps % CKPT_EVERY, steps)]
    for run in runs:
        mid = run["resume"]["mid"]
        want = [h for h in _no_time(run[RESUME_CASE]["hist"]) if h["step"] > mid]
        assert _no_time(run["resume"]["hist"]) == want and len(want) == steps - mid + 1
    name = f"step_{steps:010d}"
    with np.load(work / "A" / name / "arrays.npz") as za, \
            np.load(work / "B" / name / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        assert all(np.array_equal(za[k], zb[k]) for k in za.files)


@pytest.mark.parametrize("name,staleness", PREFETCH)
def test_gloo_prefetch_is_bit_identical_to_the_synchronous_run(gloo_runs, name, staleness):
    """Each process's prefetcher drains its own grid stream (its feed
    columns, or ONDEMAND's global rows) and rebases on the host: at
    staleness 0 and 1 the run equals the synchronous one bit for bit."""
    for run in gloo_runs(2)[1]:
        assert _no_time(run[f"{name}-staleness{staleness}"]) == _no_time(run[name]["hist"])


@pytest.mark.parametrize("world", [2, 3])
def test_shard_aligned_epoch_rank_is_feed_transposed_as_in_jax(world):
    raw = make_traffic_series(500, 3)
    spec, jspec = WindowSpec(horizon=4), JWindowSpec(horizon=4)
    ds, jds = IndexDataset.from_raw(raw, spec), JIndexDataset.from_raw(raw, jspec)
    ours = tsamplers.ShardAlignedBatchSampler(ds.entries, spec, ds.train_windows, 4,
                                              world, seed=3)
    theirs = jsamplers.ShardAlignedBatchSampler(jds.entries, jspec, jds.train_windows,
                                                4, world, seed=3)
    for epoch in range(3):
        for rank in range(world):
            got = ours.epoch_rank(epoch, rank)
            np.testing.assert_array_equal(got, ours.feed(rank, epoch))
            np.testing.assert_array_equal(got, theirs.epoch_rank(epoch, rank))
