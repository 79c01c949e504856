"""Elastic serving fleet: per-host planes behind one coordinator.

Planes stop being objects in one process and become worker processes that
announce liveness through the heartbeat transports
(``repro_torch.distributed.transport``), while a coordinator uses the
``LeaderTracker`` of elastic training as its liveness oracle:

- ``ServeWorker``: one serving process, a single-plane ``ServeEngine``
  wrapped in a mailbox pump.  Every tick it drains its inbox
  (assign/cancel/stop), runs one engine step, and reports every NEWLY
  generated token plus completions back to the coordinator, then emits a
  heartbeat.  Streaming tokens per tick is what makes the restore path
  possible: the coordinator always knows each request's generated prefix.

- ``FleetEngine``: the coordinator.  ``Router`` admission (validation,
  backpressure, deadlines), block/slot capacity mirrored per worker (the
  same ``blocks_for`` arithmetic the worker's own pool enforces, so the
  mirror is exact), assignment of queued requests to live workers, and the
  RESTORE path: when the tracker times a worker out, its in-flight requests
  are re-queued at the front and re-prefilled on survivors from
  ``prompt + generated prefix`` with the remaining budget.  Greedy
  continuation depends only on the token prefix, and sampled draws are
  request-keyed by absolute position (``serve.sampling``): the survivor's
  prefill draw at position ``plen + g`` uses the very key the dead worker
  would have used for its next decode step, so the restored request
  generates what the uninterrupted one would have (the prefill computes
  those logits by another path than decode, so only a near-tie that float
  rounding flips could differ; bf16's roundings are coarse enough that such
  flips are frequent, in the JAX package too).  A returning worker re-attaches with a
  fresh mailbox incarnation (``attempt``); its resumed beats make the
  tracker report it live again and the coordinator assigns to it like any
  survivor.

Mailboxes are single-writer single-reader ordered spools.  ``FileMailbox``
uses the same atomic write+rename idiom as ``FileHeartbeatTransport`` (a
message is visible only when complete) and strictly sequential sequence
numbers (the reader stops at the first gap, so reordered directory listings
cannot reorder messages).  ``LocalMailbox`` is the in-process flavour for
tests; it round-trips through JSON so both flavours present identical
payloads (string keys).

Stale-incarnation safety: every assign/report carries the worker's
``attempt``.  After a kill + re-attach, messages from the dead incarnation
(still sitting in its old spool, or racing in) are dropped on both sides, so
a request can never be double-finished by its pre-kill ghost.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.distributed.leader import LeaderTracker
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.router import Router, ServeRequest, TERMINAL_STATUSES
from repro_torch.serve.server import ServeConfig, validate_request


# ------------------------------------------------------------------ mailboxes
class LocalMailbox:
    """In-process single-writer single-reader message spool (test flavour)."""

    def __init__(self):
        self._q: deque[dict] = deque()

    def send(self, payload: dict) -> None:
        # JSON round-trip so payloads look exactly like the file flavour's
        self._q.append(json.loads(json.dumps(payload)))

    def recv(self) -> list[dict]:
        out = list(self._q)
        self._q.clear()
        return out


class FileMailbox:
    """Cross-process spool: one JSON file per message, atomic rename,
    strictly sequential sequence numbers.

    Single writer, single reader.  The reader consumes files in sequence
    order and stops at the first missing number, so a directory listing that
    surfaces ``m_00000007`` before ``m_00000006`` (or a message still being
    written) just delays it one poll: messages are never reordered or torn.
    A fresh incarnation of a worker gets a FRESH directory (the coordinator
    bumps ``attempt``), so restart sequence-number reuse cannot happen.
    """

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        seqs = [int(n[2:10]) for n in os.listdir(directory)
                if n.startswith("m_") and n.endswith(".json")]
        self._seq = max(seqs, default=0)  # writer side
        self._next = 1  # reader side

    def send(self, payload: dict) -> None:
        self._seq += 1
        fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=self.dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, os.path.join(self.dir, f"m_{self._seq:08d}.json"))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def recv(self) -> list[dict]:
        out = []
        while True:
            path = os.path.join(self.dir, f"m_{self._next:08d}.json")
            try:
                with open(path) as f:
                    out.append(json.load(f))
            except (OSError, ValueError):
                break  # missing or mid-write: next poll
            self._next += 1
        return out


# --------------------------------------------------------------------- worker
class ServeWorker:
    """One serving process: plane + engine + mailbox pump.

    Wraps a single-plane ``ServeEngine`` (contiguous or paged per the
    ServeConfig), so the worker inherits the whole serving stack: batched
    prefill, block accounting, retirement rules, one pull per step.  The
    worker's engine queue is unbounded: fleet-level backpressure lives in
    the coordinator's router, which never assigns beyond this worker's
    slot/block capacity anyway.
    """

    def __init__(self, params, cfg, serve: ServeConfig, *, worker_id: int,
                 inbox, outbox, heartbeat=None, attempt: int = 0,
                 mesh=None, device: str | torch.device = "cuda"):
        self.engine = ServeEngine(params, cfg, serve, planes=1, mesh=mesh,
                                  queue_limit=10**9, device=device)
        self.worker_id = worker_id
        self.attempt = attempt
        self.inbox, self.outbox, self.hb = inbox, outbox, heartbeat
        self._reqs: dict[int, ServeRequest] = {}  # fleet rid -> local request
        self._reported: dict[int, int] = {}  # fleet rid -> tokens reported
        self._done_sent: set[int] = set()
        self.step_no = 0
        self.stopped = False
        self._tick_beats = True  # run() moves beating to its own thread

    def _pump_inbox(self) -> None:
        for msg in self.inbox.recv():
            kind = msg.get("kind")
            if kind == "stop":
                self.stopped = True
            elif kind == "assign" and msg.get("attempt") == self.attempt:
                for r in msg["reqs"]:
                    # the assignment pins the COORDINATOR's rid and sampling
                    # contract: keyed draws depend on (seed, rid, position)
                    # only, so a restore onto this worker re-derives the dead
                    # incarnation's stream
                    self.engine.submit(np.asarray(r["prompt"], np.int32),
                                       max_new_tokens=r["budget"],
                                       rid=int(r["rid"]),
                                       seed=int(r["seed"]),
                                       temperature=float(r["temperature"]),
                                       top_k=int(r["top_k"]),
                                       top_p=float(r["top_p"]))
                    req = self.engine.router.queue[-1]
                    self._reqs[int(r["rid"])] = req
                    self._reported[int(r["rid"])] = 0
            elif kind == "cancel" and msg.get("attempt") == self.attempt:
                req = self._reqs.get(int(msg["rid"]))
                if req is not None and req.status in ("queued", "active"):
                    # an already-passed deadline: the engine's sweep expires
                    # it (queued or holding a lane) on the next step
                    req.deadline = float("-inf")

    def tick(self) -> int:
        """One worker turn: pump inbox, one engine step, report, beat.
        Returns live lanes + queued (0 = idle)."""
        self._pump_inbox()
        live = 0 if self.stopped else self.engine.step()
        toks: dict[str, list[int]] = {}
        done: dict[str, str] = {}
        for rid, req in self._reqs.items():
            n = self._reported[rid]
            if len(req.out) > n:
                toks[str(rid)] = [int(t) for t in req.out[n:]]
                self._reported[rid] = len(req.out)
            if req.status in TERMINAL_STATUSES and rid not in self._done_sent:
                done[str(rid)] = req.status
                self._done_sent.add(rid)
        # tokens and completions ship in ONE message: a crash between "sent
        # the EOS token" and "sent done" is impossible, which keeps the
        # coordinator's restore arithmetic exact
        self.outbox.send({"kind": "report", "attempt": self.attempt,
                          "step": self.step_no, "toks": toks, "done": done,
                          "free_slots": len(self.engine.planes[0].free_slots())})
        if self.hb is not None and self._tick_beats:
            self.hb.emit(self.worker_id, self.step_no)
        self.step_no += 1
        return live

    def run(self, *, poll_s: float = 0.01, step_delay: float = 0.0,
            beat_s: float = 0.25) -> None:
        """Process main loop: tick until a stop message arrives.

        Beats move to a daemon thread: liveness means "the PROCESS is up",
        not "the step loop is fast".  A first prefill (kernel builds, the
        allocator warming up) can block a tick for many seconds, and beating
        from the tick loop would make the coordinator declare a healthy
        worker dead and double-serve its work.  A SIGKILL still silences
        the thread.  The thread is the SOLE emitter (``emit``'s per-rank seq
        counter is not thread-safe)."""
        beats = None
        if self.hb is not None:
            self._tick_beats = False

            def beat():
                while not self.stopped:
                    self.hb.emit(self.worker_id, self.step_no)
                    time.sleep(beat_s)

            beats = threading.Thread(target=beat, daemon=True)
            beats.start()
        while not self.stopped:
            busy = self.tick()
            if step_delay:
                time.sleep(step_delay)
            elif not busy:
                time.sleep(poll_s)
        if beats is not None:
            beats.join()  # no thread left running as the process exits


# ---------------------------------------------------------------- coordinator
@dataclasses.dataclass
class _WorkerHandle:
    wid: int
    send: object  # coordinator -> worker mailbox
    recv: object  # worker -> coordinator mailbox
    attempt: int = 0
    #: fleet rid -> (request, mirrored lifetime block cost)
    inflight: dict = dataclasses.field(default_factory=dict)
    live_prev: bool = True
    served: int = 0  # completions credited to this worker


class FleetEngine:
    """Coordinator for a fleet of ``ServeWorker`` processes.

    Liveness comes from ``LeaderTracker`` over a heartbeat ``step_feed``,
    the beat -> timeout machinery elastic training uses; here the "plan" a
    death triggers is re-assignment of the dead worker's in-flight requests
    (see the module docstring for the restore path).  The tracker's
    beat-refresh semantics also give re-join for free: a returned worker's
    fresh beats flip it live again.
    """

    def __init__(self, serve: ServeConfig, *, world: int, step_feed=None,
                 tracker=None, hb_timeout: float = 2.0,
                 queue_limit: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.serve = serve
        self.world = world
        self.clock = clock
        if queue_limit is None:
            queue_limit = 4 * world * serve.slots
        self.router = Router(serve, queue_limit=queue_limit, clock=clock)
        self.step_feed = step_feed
        self.tracker = tracker or LeaderTracker(world, own_ranks=(),
                                                timeout=hb_timeout, clock=clock)
        self.workers: dict[int, _WorkerHandle] = {}
        self._requeue: deque[ServeRequest] = deque()  # restore path, FIFO front
        self._block_size = serve.block_size
        self._pool_capacity = serve.pool_capacity()

    # -------------------------------------------------------------- topology
    def attach(self, wid: int, *, send, recv, attempt: int | None = None) -> None:
        """(Re-)attach a worker's mailbox pair.  Re-attaching bumps the
        incarnation ``attempt`` and restores any in-flight requests the old
        incarnation still held (covers an explicit relaunch that races the
        tracker's timeout verdict)."""
        old = self.workers.get(wid)
        if old is not None and old.inflight:
            self._restore(old)
        if attempt is None:
            attempt = 0 if old is None else old.attempt + 1
        self.workers[wid] = _WorkerHandle(wid, send, recv, attempt=attempt)

    def stop_workers(self) -> None:
        for w in self.workers.values():
            w.send.send({"kind": "stop"})

    # ------------------------------------------------------------- admission
    def _block_cost(self, total_tokens: int) -> int:
        return -(-min(total_tokens, self.serve.max_len) // self._block_size)

    def submit(self, prompt_tokens, *, max_new_tokens: int | None = None,
               deadline_s: float | None = None, seed: int | None = None,
               temperature: float | None = None, top_k: int | None = None,
               top_p: float | None = None) -> int:
        """Admit a request (``Backpressure`` / ``ValueError`` as the engine).
        Sampling overrides ride the request through assignment and restore."""
        if self._block_size is not None:
            prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
            budget = validate_request(self.serve, prompt, max_new_tokens)
            need = self._block_cost(prompt.size + budget)
            if need > self._pool_capacity:
                raise ValueError(
                    f"request needs {need} blocks; worker pools only have "
                    f"{self._pool_capacity}: raise pool_blocks or shorten "
                    f"the request")
        return self.router.submit(prompt_tokens, max_new_tokens=max_new_tokens,
                                  deadline_s=deadline_s, seed=seed,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p)

    # --------------------------------------------------------------- restore
    def _finalize(self, req: ServeRequest, status: str = "ok") -> None:
        self.router.finish(req, status=status)

    def _restore(self, w: _WorkerHandle) -> None:
        """Re-queue a dead incarnation's in-flight requests (front of line).
        Requests whose reported prefix already satisfies them (budget met or
        EOS: only the worker's final 'done' was lost) finalize directly."""
        for rid, (req, _cost) in list(w.inflight.items()):
            hit_eos = (self.serve.eos_id is not None and req.out
                       and req.out[-1] == self.serve.eos_id)
            if len(req.out) >= req.budget or hit_eos:
                self._finalize(req)
            else:
                req.status = "queued"
                self._requeue.append(req)
        w.inflight.clear()

    # ------------------------------------------------------------------ tick
    def _pump_reports(self) -> None:
        for w in self.workers.values():
            for msg in w.recv.recv():
                if (msg.get("kind") != "report"
                        or msg.get("attempt") != w.attempt):
                    continue  # stale incarnation or foreign message
                for rid_s, toks in msg.get("toks", {}).items():
                    ent = w.inflight.get(int(rid_s))
                    if ent is not None:
                        ent[0].out.extend(int(t) for t in toks)
                for rid_s, status in msg.get("done", {}).items():
                    ent = w.inflight.pop(int(rid_s), None)
                    if ent is not None:
                        self._finalize(ent[0], status=status)
                        w.served += 1

    def _capacity(self, w: _WorkerHandle) -> tuple[int, int | None]:
        free_slots = self.serve.slots - len(w.inflight)
        if self._block_size is None:
            return free_slots, None
        used = sum(cost for _req, cost in w.inflight.values())
        return free_slots, self._pool_capacity - used

    def _dispatch(self, live: set[int]) -> None:
        targets = [w for wid, w in self.workers.items() if wid in live]
        if not targets:
            return
        assigns: dict[int, list[dict]] = {}
        while True:
            src = self._requeue if self._requeue else self.router.queue
            if not src:
                break
            req = src[0]
            # continuation semantics: prompt + generated prefix, remaining
            # budget; the same arithmetic for a fresh request (empty out)
            total = req.prompt.size + req.budget  # lifetime tokens
            cost = (self._block_cost(total)
                    if self._block_size is not None else 0)
            best = None
            for w in targets:
                free_slots, free_blocks = self._capacity(w)
                if free_slots - len(assigns.get(w.wid, ())) < 1:
                    continue
                pend = sum(a["_cost"] for a in assigns.get(w.wid, ()))
                if free_blocks is not None and free_blocks - pend < cost:
                    continue
                load = len(w.inflight) + len(assigns.get(w.wid, ()))
                if best is None or load < best[0]:
                    best = (load, w)
            if best is None:
                break
            w = best[1]
            src.popleft()
            req.status = "active"
            full_prompt = req.prompt.tolist() + [int(t) for t in req.out]
            assigns.setdefault(w.wid, []).append({
                "rid": req.rid, "prompt": full_prompt,
                "budget": req.budget - len(req.out), "_cost": cost,
                "seed": req.sample.seed,
                "temperature": req.sample.temperature,
                "top_k": req.sample.top_k, "top_p": req.sample.top_p,
                "_req": req})
        for wid, entries in assigns.items():
            w = self.workers[wid]
            for e in entries:
                w.inflight[e["rid"]] = (e.pop("_req"), e.pop("_cost"))
            w.send.send({"kind": "assign", "attempt": w.attempt,
                         "reqs": entries})

    def tick(self) -> int:
        """One coordinator turn: observe beats, restore dead workers' work,
        pump reports, expire deadlines, dispatch.  Returns pending work."""
        if self.step_feed is not None:
            self.tracker.observe(self.step_feed())
        live = set(self.tracker.live())
        for w in self.workers.values():
            alive = w.wid in live
            if w.live_prev and not alive and w.inflight:
                self._restore(w)
            w.live_prev = alive
        self._pump_reports()
        self.router.expire()
        for w in self.workers.values():
            for rid, (req, _cost) in list(w.inflight.items()):
                if self.router.past_deadline(req):
                    w.inflight.pop(rid)
                    self._finalize(req, status="timeout")
                    w.send.send({"kind": "cancel", "attempt": w.attempt,
                                 "rid": rid})
        self._dispatch(live)
        return self.pending()

    def pending(self) -> int:
        return (len(self.router.queue) + len(self._requeue)
                + sum(len(w.inflight) for w in self.workers.values()))

    def results(self) -> dict[int, list[int]]:
        return self.router.results()
