"""The port's checkpoints, durable history and restart signal.

- ``repro_torch.distributed.checkpoint``: round trip, retention, corruption
  detection, shape checks, async errors and the manifest meta (mirroring
  tests/test_distributed.py), and the on-disk format shared with the JAX
  package: each package restores, leaf for leaf, what the other wrote;
- ``JsonlHistorySink``: durability, first-wins dedup on ``(epoch, step)``
  and a torn final line (mirroring tests/test_history_sink.py);
- a ``health_cb`` that raises ``RestartSignal`` mid-epoch: the loop
  checkpoints and annotates the signal, and the resume's losses equal an
  uninterrupted port run's bit for bit and the JAX package's within
  test_torch_model.py's tolerance (atol 1e-5, rtol 1e-4).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import WindowSpec as JWindowSpec
from repro.data import make_traffic_series
from repro.distributed import Checkpointer as JCheckpointer
from repro.distributed import restore as jax_restore
from repro.launch.mesh import make_host_mesh
from repro.optim import AdamConfig as JAdam
from repro.pipeline import PipelineConfig as JPipelineConfig
from repro.pipeline import build_pipeline as jax_build_pipeline
from repro.train import TrainLoopConfig as JLoop
from repro_torch.core import WindowSpec
from repro_torch.distributed import Checkpointer, checkpoint_meta, latest_step, restore
from repro_torch.distributed import checkpoint
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train import (JsonlHistorySink, RestartSignal, TrainLoopConfig,
                               run_training)
from repro_torch.train.loop import init_train_state
from repro_torch.tree import tree_leaves, tree_map

ATOL, RTOL = 1e-5, 1e-4


# ------------------------------------------------------------------ checkpoint
def _tiny_state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn((4, 3), generator=g),
                       "stack": [torch.arange(5.0), torch.ones((2, 2))]},
            "opt": {"step": 7}}


def _zeros_like(state):
    return tree_map(lambda t: torch.zeros_like(t) if isinstance(t, torch.Tensor) else 0,
                    state)


def _assert_equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    state = _tiny_state()
    ck.save(state, step=10)
    state["params"]["w"].add_(1.0)  # the snapshot was a copy
    ck.wait()
    restored, step = restore(str(tmp_path), _zeros_like(state))
    assert step == 10
    _assert_equal_trees(restored, _tiny_state())
    assert isinstance(restored["opt"]["step"], int)
    assert restore(str(tmp_path), _zeros_like(state), device="cpu")[0]["params"]["w"] \
        .device.type == "cpu"
    # bfloat16 moments (AdamConfig(state_dtype="bfloat16")) go to disk widened
    # to float32, which numpy can hold, and come back exactly
    m = torch.randn((3, 5), generator=torch.Generator().manual_seed(1)).bfloat16()
    ck.save({"m": m}, step=11)
    ck.wait()
    back, _ = restore(str(tmp_path), {"m": torch.zeros_like(m)})
    assert back["m"].dtype == torch.bfloat16 and torch.equal(back["m"], m)


def test_checkpoint_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        ck.save(_tiny_state(), step=s)
    assert ck.steps() == [3, 4]
    assert latest_step(str(tmp_path)) == 4
    assert latest_step(str(tmp_path / "missing")) is None


def test_checkpoint_detects_corruption_and_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(_tiny_state(), step=5)
    bad = _zeros_like(_tiny_state())
    bad["params"]["w"] = torch.zeros((5, 5))
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path), bad)
    path = os.path.join(str(tmp_path), "step_0000000005", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(30)
        f.write(b"\xde\xad")
    with pytest.raises(IOError, match="checksum"):
        restore(str(tmp_path), _zeros_like(_tiny_state()))


def test_checkpoint_async_overlaps_and_surfaces_errors(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path / "ok"), keep=1)
    ck.save(_tiny_state(), step=1)  # async
    ck.save(_tiny_state(), step=2)  # waits for 1, then writes 2
    ck.wait()
    assert ck.steps() == [2]

    def disk_full(path):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_sha256", disk_full)
    ck.save(_tiny_state(), step=3)  # the writer thread fails
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    ck.wait()  # the error is reported once
    assert ck.steps() == [2]  # nothing half-written became a checkpoint


def test_checkpoint_meta_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    ck.save(_tiny_state(), step=4, meta={"epoch": 1, "done_in_epoch": 2})
    assert checkpoint_meta(str(tmp_path)) == {"epoch": 1, "done_in_epoch": 2}
    ck.save(_tiny_state(), step=9)  # meta-less saves read back empty
    assert checkpoint_meta(str(tmp_path)) == {}
    assert checkpoint_meta(str(tmp_path), step=4) == {"epoch": 1, "done_in_epoch": 2}
    manifest = json.load(open(tmp_path / "step_0000000004" / "manifest.json"))
    assert manifest["format"] == 1 and manifest["step"] == 4
    assert manifest["leaves"]["opt/step"] == {"shape": [], "dtype": "int32"}
    assert manifest["leaves"]["params/stack/1"] == {"shape": [2, 2], "dtype": "float32"}


def test_each_package_restores_what_the_other_wrote(tmp_path):
    jstate = {"params": {"w": jax.random.normal(jax.random.PRNGKey(0), (4, 3)),
                         "stack": [jnp.arange(5.0), jnp.ones((2, 2))]},
              "opt": {"step": jnp.asarray(7, jnp.int32)}}
    jck = JCheckpointer(str(tmp_path / "jax"), async_write=False)
    jck.save(jstate, step=3, meta={"epoch": 0, "done_in_epoch": 3})
    ours, step = restore(str(tmp_path / "jax"), _zeros_like(_tiny_state()))
    assert step == 3 and ours["opt"]["step"] == 7
    assert checkpoint_meta(str(tmp_path / "jax")) == {"epoch": 0, "done_in_epoch": 3}
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))

    Checkpointer(str(tmp_path / "port"), async_write=False).save(
        _tiny_state(), step=11, meta={"epoch": 2, "done_in_epoch": 0})
    theirs, step = jax_restore(str(tmp_path / "port"), jstate)
    assert step == 11
    for a, b in zip(jax.tree.leaves(theirs), tree_leaves(_tiny_state())):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == (np.int32 if isinstance(b, int) else np.float32)


# ------------------------------------------------------------- history sink
class _StubSampler:
    steps_per_epoch = 4

    def epoch_global(self, epoch):
        return np.arange(4)[:, None] + 10 * epoch


def _stub_step(state, batch):
    return state, {"loss": torch.tensor(float(batch[0]))}


def _run(sink, *, start_step=0, start_done=None, eval_fn=None):
    return run_training(
        state={}, train_step=_stub_step, sampler=_StubSampler(),
        batch_of_starts=lambda row: row, loop=TrainLoopConfig(epochs=1, log_every=1),
        eval_fn=eval_fn, start_step=start_step, start_done_in_epoch=start_done,
        history_sink=sink)


def test_sink_rows_are_durable_and_deduplicated_on_resume(tmp_path):
    path = str(tmp_path / "h.jsonl")
    first = JsonlHistorySink(path)
    _run(first, eval_fn=lambda st: {"val_mae": 2.0})
    first.close()
    durable = JsonlHistorySink(path).load()
    assert durable == first.rows
    assert [r["step"] for r in durable if "epoch_time_s" not in r] == [1, 2, 3, 4]
    # a resume from a mid-epoch checkpoint re-runs steps 3..4 and the summary
    relaunch = JsonlHistorySink(path)
    _, hist = _run(relaunch, start_step=2, start_done=2,
                   eval_fn=lambda st: {"val_mae": 2.0})
    assert relaunch.rows == [] and len(hist) == 3
    relaunch.close()
    keys = [JsonlHistorySink._key(r) for r in JsonlHistorySink(path).load()]
    assert len(keys) == len(set(keys)) == 5


def test_sink_drops_a_torn_final_line(tmp_path):
    path = str(tmp_path / "h.jsonl")
    sink = JsonlHistorySink(path)
    sink.append({"step": 1, "epoch": 0, "loss": 0.5})
    sink.close()
    with open(path, "a") as f:
        f.write('{"step": 2, "epoch": 0, "lo')  # torn by a crash
    relaunch = JsonlHistorySink(path)
    assert [r["step"] for r in relaunch.load()] == [1]
    assert relaunch.append({"step": 2, "epoch": 0, "loss": 0.25})  # re-logged
    assert not relaunch.append({"step": 1, "epoch": 0, "loss": 0.5})
    relaunch.close()
    assert [r["step"] for r in JsonlHistorySink(path).load()] == [1, 2]
    assert open(path).read().endswith("\n")


# ------------------------------------------------ restart signal and resume
NODES, ENTRIES, B = 3, 120, 8
SPEC = dict(horizon=2, input_len=2)


def _loss(p, x, y, mean=torch.mean):
    pred = x[:, -1] * p["w"]
    return mean((pred - y[:, 0]) ** 2), {}


def _port_pipe(ckpt_dir):
    return build_pipeline(
        make_traffic_series(ENTRIES, NODES), WindowSpec(**SPEC), _loss,
        {"w": torch.full((NODES, 2), 0.1)},
        PipelineConfig(batch_per_rank=B, seed=7, adam=AdamConfig(lr=1e-2), device="cpu",
                       loop=TrainLoopConfig(epochs=2, log_every=1, ckpt_dir=ckpt_dir,
                                            ckpt_every=3)))


def _losses(hist):
    return [(h["step"], h["loss"]) for h in hist if "epoch_time_s" not in h]


def test_restart_signal_checkpoints_and_the_resume_is_bit_identical(tmp_path):
    ref_state, ref_hist = _port_pipe(str(tmp_path / "ref")).fit(eval_fn=None)
    pipe = _port_pipe(str(tmp_path / "run"))
    spe = pipe.steps_per_epoch
    stop_at = spe + 4  # mid-epoch 1, not on a ckpt_every boundary

    def health_cb(step):
        if step == stop_at:
            raise RestartSignal(reason="worker lost")

    loop = pipe.config.loop
    state = init_train_state(tree_map(torch.clone, pipe.init_params), pipe.config.adam)
    with pytest.raises(RestartSignal, match="worker lost") as info:
        run_training(state=state, train_step=pipe.train_step, sampler=pipe.dataplane,
                     batch_of_starts=pipe.batch_of_starts, loop=loop,
                     checkpointer=Checkpointer(loop.ckpt_dir), health_cb=health_cb)
    sig = info.value
    assert (sig.epoch, sig.step) == (1, stop_at) and sig.state is not None
    assert latest_step(loop.ckpt_dir) == stop_at
    assert checkpoint_meta(loop.ckpt_dir) == {"epoch": 1, "done_in_epoch": 4}

    state, hist = pipe.fit(eval_fn=None)  # resumes from the signal's checkpoint
    assert _losses(sig.history) + _losses(hist) == _losses(ref_hist)
    for a, b in zip(tree_leaves(ref_state), tree_leaves(state)):
        assert a == b if isinstance(a, int) else torch.equal(a, b)

    # ... and the uninterrupted JAX package run agrees within tolerance
    jpipe = jax_build_pipeline(
        make_traffic_series(ENTRIES, NODES), JWindowSpec(**SPEC), make_host_mesh(),
        lambda p, x, y: _loss(p, x, y, mean=jnp.mean),
        {"w": jnp.full((NODES, 2), 0.1, jnp.float32)},
        JPipelineConfig(batch_per_rank=B, seed=7, adam=JAdam(lr=1e-2),
                        loop=JLoop(epochs=2, log_every=1)))
    _, jhist = jpipe.fit(eval_fn=None)
    ours, theirs = _losses(ref_hist), _losses(jhist)
    assert [s for s, _ in ours] == [s for s, _ in theirs]
    np.testing.assert_allclose([v for _, v in ours], [v for _, v in theirs],
                               atol=ATOL, rtol=RTOL)
