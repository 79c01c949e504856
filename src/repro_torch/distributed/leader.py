"""Leader succession: every surviving rank can become the decider/writer.

Without it, process 0 is at once the only heartbeat decider, the only
checkpoint writer, the only plan emitter and the only history sink, and
losing it kills the run: the single-owner coordination bottleneck DistTGL
and MSPipe flag for distributed temporal-GNN training, showing up as a
fault-tolerance hole instead of a throughput one.

This module removes the single owner with a *deterministic succession
rule*: **the lowest live rank is the leader.**  Every process tracks the
same seq-gated heartbeat state (the file transport is symmetric; the TCP
collectors peer-mirror — :mod:`repro_torch.distributed.transport`), so
every survivor derives the same verdict from the same beats, and no
election protocol or extra round-trips are needed — when rank 0 dies, rank
1 *is* the leader the moment it can attribute the death, and it already
holds a primed beat table and a warm standby checkpoint.

Three pieces:

- :class:`LeaderTracker` — the pure succession rule.  Fed the same
  ``step_feed`` events the :class:`~repro_torch.distributed.elastic
  .HeartbeatMonitor` consumes plus explicit post-collective-failure
  verdicts (``note_dead``), it answers ``leader()`` / ``is_leader()``.
- :class:`LeaderCheckpointer` — checkpoint-writer succession.  Every
  process drives it exactly like a :class:`~repro_torch.distributed
  .checkpoint.Checkpointer`; the current leader's saves land on disk, while
  every standby holds the would-be checkpoint as a host-resident snapshot.
  On succession, ``takeover()`` durably writes that snapshot — the exact
  failure-step state, even though the device tensors may by then be
  unusable after the failed collective.  It issues no collective: the
  leader may be any process, and a standby may be the only survivor.
- :class:`LeaderHistorySink` — history-writer succession.  The leader's
  rows land in the crash-durable JSONL sink immediately; standbys buffer,
  and ``flush_as_leader()`` after a takeover makes the buffered rows
  durable (the sink's first-wins (epoch, step) dedup keeps rows the dead
  leader already wrote — identical values in a lock-step run).

Split-brain note: at most one rank can be the minimum of any live-set, so
two DIFFERENT verdicts can only disagree transiently (one survivor has
timed the leader out, another has not — e.g. the leader is stalled, not
dead).  The writers are hardened for that window on two different
budgets: checkpoint saves tolerate a transient double-writer outright
(atomic per-step directories, lock-step-identical content, monotonic step
numbers), while the shared history FILE — where a second writer would
truncate and interleave — is only ever taken over through the explicit
attribution path (``note_dead`` → ``succeed_as_leader`` →
``flush_as_leader``), never by a timeout-flipped gate alone (see
:class:`LeaderHistorySink`).

The JAX package's ``repro.distributed.leader`` call for call, over the
port's :class:`Checkpointer` and :class:`JsonlHistorySink`.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable

from repro_torch.distributed.checkpoint import Checkpointer
from repro_torch.train.loop import JsonlHistorySink


class LeaderTracker:
    """Deterministic leader succession: the lowest live rank wins.

    ``own_ranks`` are the feed ranks THIS process drives (several on a
    host owning multiple data-parallel slots); ``is_leader()`` is simply
    "is the fleet-wide minimum live rank one of mine".  Liveness mirrors
    the :class:`HeartbeatMonitor` contract: a rank is live until it goes
    ``timeout`` without a beat — timed from the first ``observe`` for
    ranks that have never beaten, so compile/startup can't flip
    leadership — or until a collective failure is attributed to it
    (``note_dead``), which is immediate: the survivor that caught the
    failed collective must not wait out a timeout to take over writing.
    """

    def __init__(self, world: int, own_ranks: Iterable[int] = (), *,
                 timeout: float = 60.0, clock: Callable[[], float] = time.monotonic):
        self.world = int(world)
        self.own_ranks = {int(r) for r in own_ranks}
        self.timeout = timeout
        self._clock = clock
        self._last_seen: dict[int, float] = {}
        self._dead: set[int] = set()
        self._first_observe: float | None = None

    def bind(self, own_ranks: Iterable[int]) -> None:
        """Set the ranks this process owns (known once the data plane is
        built — e.g. ``DataPlane.process_ranks``)."""
        self.own_ranks = {int(r) for r in own_ranks}

    # -------------------------------------------------------------- liveness
    def observe(self, beats: dict) -> None:
        """Feed one ``step_feed`` poll's events (``{rank: (step, ...)}``).
        Out-of-world ranks (returned workers announcing) are ignored —
        leadership is decided among the CURRENT fleet."""
        now = self._clock()
        if self._first_observe is None:
            self._first_observe = now
        for rank in beats:
            r = int(rank)
            if 0 <= r < self.world:
                self._last_seen[r] = now
                self._dead.discard(r)  # a fresh beat overrides a stale verdict

    def note_dead(self, ranks: Iterable[int]) -> None:
        """External death verdict — post-collective-failure attribution via
        ``transport.snapshot()``.  Takes effect immediately (no timeout)."""
        self._dead.update(int(r) for r in ranks)

    def live(self) -> list[int]:
        now = self._clock()
        out = []
        for r in range(self.world):
            if r in self._dead:
                continue
            if r in self.own_ranks:
                out.append(r)  # we beat for our own ranks by construction
                continue
            seen = self._last_seen.get(r)
            if seen is None:
                seen = now if self._first_observe is None else self._first_observe
            if now - seen <= self.timeout:
                out.append(r)
        return out

    # ------------------------------------------------------------ leadership
    def leader(self) -> int:
        """The current decider: the lowest live rank.  If nothing is live
        (we are the last survivor attributing everyone else), our own
        lowest rank leads — someone must write the post-mortem."""
        live = self.live()
        if live:
            return live[0]
        return min(self.own_ranks) if self.own_ranks else 0

    def is_leader(self) -> bool:
        return self.leader() in self.own_ranks

    def reset(self, world: int, own_ranks: Iterable[int] | None = None) -> None:
        """Re-prime for a new topology after an in-process re-mesh (ranks
        renumber; single-host, so the process owns every rank unless told
        otherwise).  Relaunch-mode fleets build fresh trackers instead."""
        self.world = int(world)
        self.own_ranks = ({int(r) for r in own_ranks}
                          if own_ranks is not None else set(range(self.world)))
        self._last_seen.clear()
        self._dead.clear()
        self._first_observe = None


class LeaderCheckpointer:
    """Checkpoint-writer succession over a plain :class:`Checkpointer`.

    Every process calls :meth:`save` on the same schedule; the proxy makes
    exactly one of them the writer at any moment:

    - the current leader's save is a normal (async, atomic) write;
    - a standby's save snapshots the state to HOST memory and holds it as
      ``pending`` — the warm-standby copy.  Holding host bytes (not device
      tensors) matters: after a failed collective the device state may be
      unusable, but the host snapshot taken while it was valid is always
      writable.

    On succession, :meth:`takeover` synchronously writes the pending
    snapshot — the successor durably owns the exact failure-step state
    before it exits for relaunch.  Nothing here is a collective (the
    plain :meth:`Checkpointer.wait` ends in a barrier; this class joins
    writes with :meth:`Checkpointer.flush`), so the processes may take
    different branches at the same step.
    """

    def __init__(self, inner: Checkpointer, is_leader: Callable[[], bool]):
        self.inner = inner
        self._is_leader = is_leader
        self._pending: tuple[dict, int, dict | None] | None = None

    def save(self, state, *, step: int, meta: dict | None = None) -> None:
        # Release the previous host copy (the in-flight async write's, or
        # the standby's pending snapshot) BEFORE materialising the new one:
        # holding both doubles peak host memory for the duration of a slow
        # write.  The standby trade-off: if the snapshot itself fails (OOM
        # — exactly when the release matters), the old pending is gone; the
        # durable store still has the previous leader-written step.
        if self._is_leader():
            self._pending = None
            self.inner.flush()
            self.inner.save_snapshot(Checkpointer.snapshot(state),
                                     step=step, meta=meta)
        else:
            self._pending = None
            self._pending = (Checkpointer.snapshot(state), step, meta)

    def takeover(self) -> int | None:
        """Durably write the standby snapshot (succession).  Returns the
        step written, or None when there is nothing pending — e.g. this
        process was already the leader and its saves are on disk."""
        if self._pending is None:
            return None
        flat, step, meta = self._pending
        self._pending = None
        self.inner.save_snapshot(flat, step=step, meta=meta, sync=True)
        return step

    @property
    def pending_step(self) -> int | None:
        return self._pending[1] if self._pending is not None else None

    def wait(self) -> None:
        """Join the in-flight write (no collective); raise if it failed."""
        self.inner.flush()

    flush = wait

    def steps(self) -> list[int]:
        return self.inner.steps()


class LeaderHistorySink:
    """History-writer succession over a :class:`JsonlHistorySink`.

    Duck-compatible with the plain-list / JSONL ``history_sink`` contract
    (``append`` / ``rows`` / ``close``).  While this process is not the
    writer, rows are buffered in memory and NOTHING touches the shared
    file — the durable sink is only opened when writer-ship is taken, so
    its torn-tail truncation runs exactly when a successor first takes
    over the file a dead leader may have been mid-write in.

    WHO writes is decided conservatively, because two concurrent writers
    on one file would duplicate rows and tear each other's lines: a
    process that is the leader at its FIRST append owns the file
    outright; a process that started as a standby can ONLY be promoted by
    an explicit :meth:`flush_as_leader` call — the launcher's
    post-collective-failure attribution path (``note_dead`` →
    ``succeed_as_leader``), where the old leader is known dead.  A
    leadership gate that merely flips on a heartbeat TIMEOUT (the old
    leader may be alive and still writing — an NFS stall, a long pause)
    never creates a second writer: the standby just keeps buffering.
    ``flush_as_leader()`` lands the buffered rows; the underlying
    first-wins (epoch, step) dedup drops every row the dead leader
    already wrote.

    ``buffer_standby=False`` turns the standby buffering off for processes
    that can never become the leader (no succession tracker bound, or a
    TCP process beyond the failover list): they would otherwise accumulate
    an unflushable copy of every row for the whole run.
    """

    def __init__(self, path: str, is_leader: Callable[[], bool] | None = None,
                 *, buffer_standby: bool = True):
        self.path = path
        self._is_leader = is_leader or (lambda: True)
        self.buffer_standby = buffer_standby
        self.rows: list[dict] = []       # every row THIS incarnation logged
        self._buffer: list[dict] = []    # standby rows awaiting a takeover
        self._writer: bool | None = None  # None = no append decided it yet
        self._sink: JsonlHistorySink | None = None

    def bind(self, is_leader: Callable[[], bool], *,
             buffer_standby: bool | None = None) -> None:
        self._is_leader = is_leader
        if buffer_standby is not None:
            self.buffer_standby = buffer_standby

    def _durable(self) -> JsonlHistorySink:
        if self._sink is None:
            self._sink = JsonlHistorySink(self.path)
        return self._sink

    def append(self, row: dict) -> bool:
        self.rows.append(row)
        if self._writer is None:
            self._writer = self._is_leader()  # leader at first append: ours
        if not self._writer:
            if self.buffer_standby:
                self._buffer.append(row)
            return False
        return self._durable().append(row)

    def flush_as_leader(self) -> int:
        """Take writer-ship after an ATTRIBUTED succession and make any
        standby-buffered rows durable; returns how many actually landed
        (duplicates of the dead leader's rows don't).  No-op unless the
        bound gate agrees this process now leads."""
        if not self._is_leader():
            return 0
        self._writer = True
        if not self._buffer:
            return 0
        sink = self._durable()
        landed = sum(1 for r in self._buffer if sink.append(r))
        self._buffer.clear()
        return landed

    def load(self) -> list[dict]:
        return self._durable().load()

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None
