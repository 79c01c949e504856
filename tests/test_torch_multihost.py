"""Elastic training of the port on real processes, on the CPU over gloo.

The port's launcher (``python -m repro_torch.launch.train``) runs as two
ranks that this file spawns itself, with the rendezvous store hosted here
(``TORCHELASTIC_USE_AGENT_STORE=True`` makes every rank a client, so a dead
rank 0 does not take the store with it), heartbeats through the file
transport, checkpoints every step and one durable history file shared by
every phase:

- **kill rank 1**: rank 1 dies right after beating step ``DIE_AT``; rank 0's
  next all-reduce fails, it attributes the death from the transport's
  snapshot and exits 75 with a shrink plan that drops ``[1]``; relaunched
  alone (world 1, the same global batch) it resumes, an announcer beats
  for rank 1 from outside the world, and it exits 75 with a grow plan; the
  relaunched pair finishes with exit 0;
- **kill rank 0**, the leader, which writes no checkpoint
  (``--ckpt-every 0``): rank 1 attributes the death, takes over (it writes
  its standby checkpoint of the failure step, the plan and its buffered
  history rows) and exits 75; a world-1 relaunch resumes from the takeover
  step and finishes.

Held: exit codes and plans; steps up to the kill bit-equal to an
uninterrupted two-process run, later steps within rtol 1e-4 of it (world 1
takes one mean over the global batch where two ranks average their two
means, as in tests/test_torch_distributed.py); step numbers monotonic with
no gap; every history row exactly once.  Every child is bounded by a
timeout.  The victim kills itself (SIGKILL) from its heartbeat emit, so the
kill lands at the same step on any machine.

Run as ``python tests/test_torch_multihost.py --die-at N -- <launcher
args>``, this file is that victim: the launcher with the self-kill hook.
"""
from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
HB_TIMEOUT = 5.0     # seconds; a step here takes a few ms
DIE_AT = 5
EX_REMESH = 75
CHILD_TIMEOUT = 180  # seconds, any one child
RTOL = 1e-4
ARGS = ["--arch", "pgt-dcrnn-pems-all-la", "--nodes", "9", "--entries", "160",
        "--batch", "4", "--epochs", "2", "--seed", "0", "--lr", "1e-3",
        "--device", "cpu", "--log-every", "1"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """Spawns ranks of the launcher; hosts each gang's rendezvous store."""

    def __init__(self, run: Path):
        self.run = run
        self.procs: list[subprocess.Popen] = []
        self.stores: list = []

    def launch(self, world: int, extra=(), *, per_rank=None, die=None,
               tag: str = "") -> list[subprocess.Popen]:
        import torch.distributed as dist

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
        base = [*ARGS, "--ckpt-dir", str(self.run / "ck"), "--history-out",
                str(self.run / "history.jsonl"), *extra]
        if world > 1:
            port = _free_port()
            self.stores.append(dist.TCPStore("127.0.0.1", port, world_size=world,
                                             is_master=True, wait_for_workers=False))
            env.update(WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       TORCHELASTIC_USE_AGENT_STORE="True")
            base.append("--init-distributed")
        out = []
        for rank in range(world):
            argv = base + list((per_rank or {}).get(rank, ()))
            if die is not None and die[0] == rank:
                cmd = [sys.executable, __file__, "--die-at", str(die[1]), "--", *argv]
            else:
                cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
            log = open(self.run / f"{tag}{rank}.log", "w")
            p = subprocess.Popen(cmd, env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                                 cwd=self.run, stdout=log, stderr=subprocess.STDOUT)
            self.procs.append(p)
            out.append(p)
        return out

    def wait(self, procs) -> list[int]:
        codes = []
        for p in procs:
            try:
                codes.append(p.wait(timeout=CHILD_TIMEOUT))
            except subprocess.TimeoutExpired:
                pytest.fail(f"a child ran past {CHILD_TIMEOUT} s: {p.args}")
        return codes

    def log(self, tag: str) -> str:
        return "\n".join((self.run / name).read_text()
                         for name in sorted(os.listdir(self.run))
                         if name.startswith(tag) and name.endswith(".log"))

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        self.stores.clear()


@pytest.fixture
def fleet(tmp_path):
    f = Fleet(tmp_path)
    yield f
    f.close()


def _rows(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines() if line.strip()]


def _losses(rows) -> dict[int, float]:
    return {r["step"]: r["loss"] for r in rows if "epoch_time_s" not in r}


def _evals(rows) -> dict[int, float]:
    return {r["epoch"]: r["val_mae"] for r in rows if "epoch_time_s" in r}


def _check_history(rows, ref_rows, last_exact: int) -> None:
    """Each row once, steps 1..total without a gap, the prefix up to
    ``last_exact`` bit-equal to the reference and the rest within RTOL."""
    steps = [r["step"] for r in rows if "epoch_time_s" not in r]
    ref = _losses(ref_rows)
    assert sorted(steps) == list(range(1, max(ref) + 1)) == sorted(set(steps))
    assert steps == sorted(steps)  # written in order across the phases
    assert [r["epoch"] for r in rows if "epoch_time_s" in r] == [0, 1]
    got = _losses(rows)
    assert all(np.isfinite(v) for v in got.values())
    assert all(got[s] == ref[s] for s in range(1, last_exact + 1))
    later = sorted(s for s in got if s > last_exact)
    np.testing.assert_allclose([got[s] for s in later], [ref[s] for s in later], rtol=RTOL)
    np.testing.assert_allclose(sorted(_evals(rows).items()),
                               sorted(_evals(ref_rows).items()), rtol=RTOL)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted two-process run (no heartbeat, no kill)."""
    run = tmp_path_factory.mktemp("ref")
    f = Fleet(run)
    try:
        assert f.wait(f.launch(2, ["--ckpt-every", "1"], tag="ref")) == [0, 0], f.log("ref")
    finally:
        f.close()
    return _rows(run / "history.jsonl")


def _plan(run: Path) -> dict:
    return json.loads((run / "plan.json").read_text())


def _elastic(run: Path, *extra) -> list[str]:
    return ["--elastic", "--elastic-remesh", "relaunch", "--heartbeat",
            f"file:{run / 'hb'}", "--heartbeat-timeout", str(HB_TIMEOUT),
            "--plan-out", str(run / "plan.json"), *extra]


def test_kill_rank1_shrink_then_grow(fleet, reference):
    run = fleet.run
    el = _elastic(run, "--target-world", "2", "--ckpt-every", "1")
    # A: two ranks; rank 1 dies after beating step DIE_AT
    codes = fleet.wait(fleet.launch(2, el, die=(1, DIE_AT), tag="a"))
    assert codes == [EX_REMESH, -signal.SIGKILL], fleet.log("a")
    plan = _plan(run)
    assert (plan["kind"], plan["dropped_workers"], plan["decided_by"]) == ("shrink", [1], 0)
    assert plan["step"] == DIE_AT
    assert "ranks [1] silent" in fleet.log("a")
    # B: the survivor alone, the same global batch; rank 1 announces its
    # return from outside the world (an id >= world 1)
    from repro_torch.distributed import FileHeartbeatTransport

    stop = threading.Event()

    def announce():
        hb = FileHeartbeatTransport(str(run / "hb"))
        step = 0
        while not stop.is_set():
            hb.emit(1, step)
            step += 1
            time.sleep(0.01)

    (b,) = fleet.launch(1, [*el, "--resume"], tag="b")
    announcer = threading.Thread(target=announce, daemon=True)
    announcer.start()
    try:
        assert fleet.wait([b]) == [EX_REMESH], fleet.log("b")
    finally:
        stop.set()
        announcer.join()
    plan = _plan(run)
    assert (plan["kind"], plan["readmitted_workers"], plan["decided_by"]) == ("grow", [1], 0)
    assert f"resuming from step {DIE_AT}" in fleet.log("b")
    grow = plan["step"]
    # C: both ranks again; they finish
    assert fleet.wait(fleet.launch(2, [*el, "--resume"], tag="c")) == [0, 0], fleet.log("c")
    assert f"resuming from step {grow}" in fleet.log("c")
    _check_history(_rows(run / "history.jsonl"), reference, DIE_AT)


def test_kill_rank0_leader_succession(fleet, reference):
    run = fleet.run
    el = _elastic(run)
    # rank 0, the leader, writes no checkpoint and dies after step DIE_AT;
    # rank 1 checkpoints (as a standby: host snapshots) every step
    procs = fleet.launch(2, el, per_rank={0: ["--ckpt-every", "0"], 1: ["--ckpt-every", "1"]},
                         die=(0, DIE_AT), tag="ka")
    assert fleet.wait(procs) == [-signal.SIGKILL, EX_REMESH], fleet.log("ka")
    plan = _plan(run)
    assert (plan["kind"], plan["dropped_workers"], plan["decided_by"]) == ("shrink", [0], 1)
    assert plan["step"] == DIE_AT
    # the successor's takeover wrote the only checkpoint there is
    assert sorted(os.listdir(run / "ck")) == [f"step_{DIE_AT:010d}"]
    assert f"checkpoint of step {DIE_AT} written on takeover" in fleet.log("ka")
    # a world-1 relaunch resumes from the takeover step and finishes
    assert fleet.wait(fleet.launch(1, [*el, "--resume"], tag="kb")) == [0], fleet.log("kb")
    assert f"resuming from step {DIE_AT}" in fleet.log("kb")
    _check_history(_rows(run / "history.jsonl"), reference, DIE_AT)


def _victim(argv: list[str]) -> None:
    """The launcher, killed with SIGKILL right after it beats step ``--die-at``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import transport
    from repro_torch.launch.train import main

    die_at = int(argv[argv.index("--die-at") + 1])
    emit = transport.FileHeartbeatTransport.emit

    def emit_then_die(self, rank, step, step_time=None):
        emit(self, rank, step, step_time)
        if step >= die_at:
            os.kill(os.getpid(), signal.SIGKILL)

    transport.FileHeartbeatTransport.emit = emit_then_die
    main(argv[argv.index("--") + 1:])


if __name__ == "__main__":
    _victim(sys.argv[1:])
