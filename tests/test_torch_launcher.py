"""The port's training launcher, ``repro_torch.launch.train.main``, on the
CPU at 9 nodes: its history rows match the JAX launcher's on the same data
and parameters (the JAX draws bridged in through ``params_from_jax``)
within test_torch_model.py's tolerance (atol 1e-5, rtol 1e-4); ``--resume``
from a mid-epoch checkpoint continues bit for bit; ``--init-distributed``,
``--placement`` and ``--no-halo`` train, in one process and under
``torch.distributed.run`` with two processes on gloo; the elastic flags
train (an all-healthy fleet, a file transport), refuse their bad
combinations and write an atomic plan on exit 75 (the kill cycles are
tests/test_torch_multihost.py).  The LM archs through the launcher:
tests/test_torch_lm_train.py and tests/test_torch_lm_launcher.py."""
import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jax_launcher
from repro.configs import get_arch as jax_get_arch
from repro.models import dcrnn as jdcrnn
from repro.models import pgt_dcrnn as jpgt
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import main
from repro_torch.models import dcrnn, pgt_dcrnn

ATOL, RTOL = 1e-5, 1e-4
NODES = 9
SMALL = ["--nodes", str(NODES), "--entries", "120", "--batch", "4", "--seed", "0"]
MODULES = {"dcrnn-pems": (dcrnn, jdcrnn), "pgt-dcrnn-pems-all-la": (pgt_dcrnn, jpgt)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The 9-node steps are far too small to share among threads, and the
    tier-1 run puts several test workers on the same cores: more torch
    threads than that only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _comparable(rows):
    return [{k: v for k, v in r.items() if k != "epoch_time_s"} for r in rows]


@pytest.fixture
def jax_params(monkeypatch):
    """The port's launcher draws its parameters from the JAX package's
    ``init`` at the same seed, so both launchers train the same model."""
    def bridge(arch_id):
        tmod, jmod = MODULES[arch_id]
        cfg = dataclasses.replace(jax_get_arch(arch_id).model, num_nodes=NODES)
        jparams = jax.device_get(jmod.init(jax.random.PRNGKey(0), cfg))
        monkeypatch.setattr(tmod, "init", lambda gen, cfg, device: params_from_jax(
            jparams, device=device))
    return bridge


@pytest.mark.parametrize("arch_id", sorted(MODULES))
def test_history_matches_the_jax_launcher(tmp_path, monkeypatch, jax_params, arch_id):
    """At lr 1e-3.  At the default 1e-2 DCRNN's training is unstable at
    this size: the JAX run's own gradient norm spikes to 137 at step 20
    (ours reads 1.65 there), so float32 summation-order differences of a
    few 1e-6 grow past any tolerance within three steps.  At 1e-3 the two
    histories agree to about 1e-6 relative over both epochs."""
    jax_params(arch_id)
    flags = ["--arch", arch_id, *SMALL, "--epochs", "2", "--gather", "pallas",
             "--lr", "1e-3"]
    _, history = main([*flags, "--device", "cpu", "--history-out", str(tmp_path / "t.jsonl")])
    monkeypatch.setattr(sys, "argv", ["train", *flags,
                                      "--history-out", str(tmp_path / "j.jsonl")])
    jax_launcher.main()
    ours, theirs = _rows(tmp_path / "t.jsonl"), _rows(tmp_path / "j.jsonl")
    assert _comparable(ours) == _comparable(history)
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [r["step"] for r in ours] == [10, 17, 20, 30, 34]  # log_every 10
    for key in ("loss", "grad_norm", "lr", "val_mae"):
        got = [r[key] for r in ours if key in r]
        want = [r[key] for r in theirs if key in r]
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=key)


def test_resume_from_a_mid_epoch_checkpoint_is_bit_identical(tmp_path, capsys):
    flags = ["--arch", "dcrnn-pems", *SMALL, "--device", "cpu", "--log-every", "1",
             "--ckpt-every", "5"]
    main([*flags, "--ckpt-dir", str(tmp_path / "a"), "--history-out", str(tmp_path / "a.jsonl")])
    assert "done: 18 logs" in capsys.readouterr().out  # 17 steps and the summary
    # a fresh directory holding only run A's step-10 checkpoint (10 of 17 done)
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000010", tmp_path / "b" / "step_0000000010")
    main([*flags, "--ckpt-dir", str(tmp_path / "b"), "--history-out", str(tmp_path / "b.jsonl"),
          "--resume"])
    assert "resuming from step 10" in capsys.readouterr().out
    a, b = _comparable(_rows(tmp_path / "a.jsonl")), _comparable(_rows(tmp_path / "b.jsonl"))
    assert b == [r for r in a if r["step"] > 10] and len(b) == 8
    # the final checkpoints agree leaf for leaf, bit for bit
    za = np.load(tmp_path / "a" / "step_0000000017" / "arrays.npz")
    zb = np.load(tmp_path / "b" / "step_0000000017" / "arrays.npz")
    assert sorted(za.files) == sorted(zb.files)
    assert all(np.array_equal(za[k], zb[k]) for k in za.files)
    # a second resume finds the run complete, and the history gains no row
    main([*flags, "--ckpt-dir", str(tmp_path / "b"), "--history-out", str(tmp_path / "b.jsonl"),
          "--resume"])
    assert "nothing to train" in capsys.readouterr().out
    assert len(_rows(tmp_path / "b.jsonl")) == 8


_HISTORIES: dict = {}


def _history(tmp_path, *extra):
    """History rows of a one-epoch dcrnn-pems run with ``extra`` flags,
    every step logged (cached by flags)."""
    if extra not in _HISTORIES:
        out = tmp_path / f"h{len(_HISTORIES)}.jsonl"
        main(["--arch", "dcrnn-pems", *SMALL, "--device", "cpu", "--log-every", "1",
              "--history-out", str(out), *extra])
        _HISTORIES[extra] = _comparable(_rows(out))
    return _HISTORIES[extra]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra,same_as", [
    (("--init-distributed",), ()),
    (("--placement", "partitioned"), None),
    (("--placement", "ondemand"), ()),
    (("--no-halo",), ()),
    (("--placement", "partitioned", "--no-halo"), ("--placement", "partitioned")),
])
def test_distributed_flags_train_in_one_process(tmp_path, monkeypatch, capsys, extra,
                                                same_as):
    """One process is one rank holding every row, so no collective runs:
    ``--init-distributed`` (a world-1 group from torch.distributed.run's
    variables), ONDEMAND's global feed and a halo that no rank follows
    train bit for bit as the run they reduce to."""
    if "--init-distributed" in extra:
        for key, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                               LOCAL_WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(_free_port())).items():
            monkeypatch.setenv(key, value)
    rows = _history(tmp_path, *extra)
    out = capsys.readouterr().out
    assert len(rows) == 18 and all(np.isfinite(r["loss"]) for r in rows)  # 17 steps
    placement = extra[extra.index("--placement") + 1] if "--placement" in extra \
        else "replicated"
    assert f"placement {placement}: rank rows (0, 120)" in out
    if "--init-distributed" in extra:
        assert "process 0 of 1, backend gloo on cpu" in out
        assert not torch.distributed.is_initialized()
    if same_as is not None:
        assert rows == _history(tmp_path, *same_as)


def test_two_processes_under_torch_distributed_run(tmp_path):
    """``torch.distributed.run`` with two CPU processes on gloo: each trains
    its own block of ONDEMAND's global batches, holding only its shard;
    process 0 alone writes the history and the checkpoints."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-addr", "127.0.0.1", "--master-port", str(_free_port()),
           "-m", "repro_torch.launch.train", "--init-distributed", "--device", "cpu",
           "--arch", "dcrnn-pems", *SMALL, "--placement", "ondemand", "--log-every", "1",
           "--ckpt-dir", str(tmp_path / "ck"), "--history-out", str(tmp_path / "h.jsonl")]
    run = subprocess.run(cmd, env=env, cwd=tmp_path, capture_output=True, text=True,
                         timeout=240)
    assert run.returncode == 0, run.stderr[-4000:]
    for rank, rows in ((0, "(0, 60)"), (1, "(60, 120)")):
        assert f"process {rank} of 2, backend gloo on cpu" in run.stdout
        assert f"placement ondemand: rank rows {rows}" in run.stdout
    # 17 steps of 2 + 2 windows and the summary, on each process
    assert run.stdout.count("done: 18 logs") == 2
    rows = _rows(tmp_path / "h.jsonl")
    assert [r["step"] for r in rows] == [*range(1, 18), 17]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_0000000017"]


def test_the_global_batch_must_divide_by_the_world(monkeypatch):
    """``--batch`` is the global batch: each of the world's ranks takes an
    equal share, as in the JAX launcher."""
    import repro_torch.launch.train as launcher

    monkeypatch.setattr(launcher, "dp_size", lambda: 3)
    with pytest.raises(SystemExit, match="--batch 4 not divisible by data-parallel size 3"):
        main(["--arch", "dcrnn-pems", *SMALL, "--device", "cpu"])


def _elastic_run(tmp_path, *extra):
    return main(["--arch", "dcrnn-pems", *SMALL, "--device", "cpu", "--log-every", "1",
                 "--ckpt-dir", str(tmp_path / "ck"), "--elastic", *extra])


def _heartbeat_needs_elastic(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--heartbeat requires --elastic"):
        main(["--arch", "dcrnn-pems", *SMALL, "--device", "cpu",
              "--heartbeat", f"file:{tmp_path / 'hb'}"])


def _a_group_needs_relaunch(tmp_path, capsys):
    with pytest.raises(SystemExit, match="needs --elastic-remesh relaunch"):
        main(["--arch", "dcrnn-pems", *SMALL, "--device", "cpu", "--init-distributed",
              "--elastic", "--ckpt-dir", str(tmp_path / "ck")])


def _elastic_alone_trains_all_healthy(tmp_path, capsys):
    """The simulated all-healthy fleet: no re-mesh, the plain run's rows."""
    _, history = _elastic_run(tmp_path)
    assert _comparable(history) == _history(tmp_path)


def _heartbeat_file_transport_trains(tmp_path, capsys):
    """One process beating through real files: its rank's file carries the
    last step, and the run is the plain run."""
    _, history = _elastic_run(tmp_path, "--heartbeat", f"file:{tmp_path / 'hb'}",
                              "--heartbeat-timeout", "30")
    assert _comparable(history) == _history(tmp_path)
    assert json.loads((tmp_path / "hb" / "hb_0.json").read_text())["step"] == 17


def _relaunch_without_target_world_warns(tmp_path, capsys):
    _, history = _elastic_run(tmp_path, "--elastic-remesh", "relaunch")
    assert "warning: --elastic-remesh relaunch without --target-world" in \
        capsys.readouterr().out
    assert _comparable(history) == _history(tmp_path)


def _plan_out_on_exit_75(tmp_path, capsys):
    """World 1 under --target-world 2, with rank 1 beating from outside the
    world: the leader plans a grow, checkpoints, writes the plan atomically
    and exits 75."""
    from repro_torch.distributed import FileHeartbeatTransport, latest_step

    stop = threading.Event()

    def announce():
        hb = FileHeartbeatTransport(str(tmp_path / "hb"))
        step = 0
        while not stop.is_set():
            hb.emit(1, step)
            step += 1
            time.sleep(0.002)

    announcer = threading.Thread(target=announce, daemon=True)
    announcer.start()
    try:
        with pytest.raises(SystemExit) as exc:
            _elastic_run(tmp_path, "--heartbeat", f"file:{tmp_path / 'hb'}",
                         "--elastic-remesh", "relaunch", "--target-world", "2",
                         "--plan-out", str(tmp_path / "plan.json"))
    finally:
        stop.set()
        announcer.join()
    assert exc.value.code == 75
    plan = json.loads((tmp_path / "plan.json").read_text())
    assert (plan["kind"], plan["readmitted_workers"], plan["decided_by"]) == ("grow", [1], 0)
    assert plan["step"] == latest_step(str(tmp_path / "ck"))
    assert sorted(os.listdir(tmp_path)) == ["ck", "hb", "plan.json"]  # no temp file left
    assert "re-mesh requested (exit 75)" in capsys.readouterr().out


ELASTIC_FLAG_CASES = {f.__name__.lstrip("_"): f for f in (
    _heartbeat_needs_elastic, _a_group_needs_relaunch, _elastic_alone_trains_all_healthy,
    _heartbeat_file_transport_trains, _relaunch_without_target_world_warns,
    _plan_out_on_exit_75)}


@pytest.mark.parametrize("case", sorted(ELASTIC_FLAG_CASES))
def test_elastic_flags(tmp_path, capsys, case):
    """The six elastic flags: ``--elastic``, ``--heartbeat``,
    ``--heartbeat-timeout``, ``--elastic-remesh``, ``--target-world`` and
    ``--plan-out``, and the checks that refuse their bad combinations."""
    ELASTIC_FLAG_CASES[case](tmp_path, capsys)


@pytest.mark.parametrize("age,dead", [(1.0, [1]), (0.0, None)])
def test_a_failed_collective_is_a_peer_death_only_if_its_beats_went_silent(age, dead):
    """After a failed collective the survivor exits 75 when a peer's beat is
    older than the heartbeat timeout (and hands it to leader succession);
    when every peer still beats, the failure is not a peer's death and the
    launcher re-raises it."""
    from types import SimpleNamespace

    import repro_torch.launch.train as launcher

    seen = []
    pipe = SimpleNamespace(world=2, dataplane=SimpleNamespace(process_ranks=[0]),
                           succeed_as_leader=lambda ranks: seen.append(ranks))
    transport = SimpleNamespace(snapshot=lambda: {0: {"step": 3, "age": 0.0},
                                                  1: {"step": 3, "age": age}})
    args = SimpleNamespace(heartbeat_timeout=0.05)
    if dead is None:
        assert launcher._succeed(pipe, transport, args, [], RuntimeError("gloo")) is None
        assert seen == []
    else:
        with pytest.raises(SystemExit) as exc:
            launcher._succeed(pipe, transport, args, [], RuntimeError("gloo"))
        assert exc.value.code == 75 and seen == [dead]


def test_the_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "dcrnn-pems", *SMALL])
