"""Request router: bounded admission queue, deadlines, prompt-length groups.

The router owns everything about a request EXCEPT device state: admission
(validation + backpressure when the queue outruns the fleet's slots),
per-request deadlines (expired requests fail fast instead of holding a decode
lane), and the prefill grouping policy — ``pop_group`` hands the engine a
same-length batch of prompts up to a token budget, which is what makes
batched prefill a single ``[k, plen]`` forward instead of k single-lane
passes.

Grouping never changes outputs: greedy decode is per-lane, so admission
order only affects WHEN a request runs, not what it generates — the fleet
bit-identity test pins this.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.serve.sampling import SampleParams
from repro_torch.serve.server import ServeConfig, validate_request

#: statuses a finished request can carry (``truncated`` = the lane was
#: retired because the cache filled before the budget was spent)
TERMINAL_STATUSES = ("ok", "timeout", "truncated")


class Backpressure(RuntimeError):
    """Raised by ``submit`` when the admission queue is full — the caller
    (load balancer, client) must retry or shed load; queueing unboundedly
    would only convert overload into timeout storms."""


@dataclasses.dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray
    budget: int
    deadline: float | None  # absolute, on the router's clock; None = never
    submitted_at: float = 0.0
    finished_at: float = 0.0
    out: list[int] = dataclasses.field(default_factory=list)
    status: str = "queued"  # queued | active | ok | timeout | truncated
    #: request-keyed sampling contract — rides WITH the request through
    #: planes, fleet mailboxes and re-prefill, so draws never depend on
    #: where the request runs
    sample: SampleParams = dataclasses.field(default_factory=SampleParams)

    @property
    def latency_s(self) -> float | None:
        """Admission→finish latency.  ``None`` until the request reaches a
        terminal status — ``finished_at`` is unset before that, and the old
        ``finished - submitted`` arithmetic went NEGATIVE on in-flight
        requests (0.0 minus a real clock reading)."""
        if self.status not in TERMINAL_STATUSES:
            return None
        return self.finished_at - self.submitted_at


class Router:
    """Admission + scheduling front of the serving engine."""

    def __init__(self, serve: ServeConfig, *, queue_limit: int | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.serve = serve
        #: max queued (not-yet-prefilled) requests; None = unbounded
        self.queue_limit = queue_limit
        self.clock = clock
        self.queue: deque[ServeRequest] = deque()
        self.done: dict[int, ServeRequest] = {}
        self._next_rid = 0

    def __len__(self) -> int:
        return len(self.queue)

    # -------------------------------------------------------------- admission
    def submit(self, prompt_tokens, *, max_new_tokens: int | None = None,
               deadline_s: float | None = None, seed: int | None = None,
               temperature: float | None = None, top_k: int | None = None,
               top_p: float | None = None, rid: int | None = None) -> int:
        """Admit a request.  Raises ``Backpressure`` when the queue is full,
        ``ValueError`` on an invalid budget/prompt (see ``validate_request``)
        or invalid sampling overrides (negative temperature, bad top_k/p).

        ``seed``/``temperature``/``top_k``/``top_p`` override the
        ``ServeConfig`` defaults for THIS request.  ``rid`` pins an explicit
        request id — the fleet seam: a worker must key its draws with the
        COORDINATOR'S rid, or re-prefill on a different host would re-derive
        a different stream."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        budget = validate_request(self.serve, prompt, max_new_tokens)
        sample = SampleParams.resolve(self.serve, seed=seed,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)
        if self.queue_limit is not None and len(self.queue) >= self.queue_limit:
            raise Backpressure(
                f"queue full ({len(self.queue)}/{self.queue_limit} requests); "
                f"retry or shed load")
        now = self.clock()
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = ServeRequest(rid, prompt, budget,
                           deadline=None if deadline_s is None else now + deadline_s,
                           submitted_at=now, sample=sample)
        self.queue.append(req)
        return req.rid

    # -------------------------------------------------------------- deadlines
    def expire(self) -> list[ServeRequest]:
        """Fail queued requests whose deadline passed (they never reach a
        slot).  Active lanes are expired by the engine, which owns them."""
        now = self.clock()
        expired = [r for r in self.queue
                   if r.deadline is not None and now >= r.deadline]
        for r in expired:
            self.queue.remove(r)
            self.finish(r, status="timeout")
        return expired

    def past_deadline(self, req: ServeRequest) -> bool:
        return req.deadline is not None and self.clock() >= req.deadline

    # ------------------------------------------------------------- scheduling
    def pop_group(self, max_requests: int, token_budget: int, *,
                  block_budget: int | None = None,
                  block_cost=None) -> list[ServeRequest]:
        """Pop a batch of SAME-prompt-length requests for one batched prefill.

        Takes the oldest queued request's prompt length as the group key and
        collects up to ``max_requests`` queued requests of that length whose
        summed prompt tokens stay within ``token_budget``.  Other lengths
        stay queued for the next group (the scan skips past them, so one
        odd-length head never starves a same-length run behind it).

        The token budget is a THROUGHPUT knob, so the group's leader always
        ships even alone — a budget smaller than one prompt must not
        deadlock.  Block accounting is different: when ``block_budget`` /
        ``block_cost`` are given (paged planes; ``block_cost(req)`` = the
        target plane's lifetime block count for ``req``), blocks are a HARD
        resource and the group's summed cost must fit the budget.  A leader
        that does not fit returns an EMPTY group — it stays queued (FIFO:
        head-of-line waits rather than being overtaken) until retirements
        free blocks; never-fitting requests are rejected at submit, so this
        cannot deadlock.

        Popped requests flip to status "active".  Grouping never changes
        outputs: decode and the request-keyed draws are per-lane, so the
        batch composition only affects WHEN a request runs (the fleet
        bit-identity tests pin this at temperature 0 AND above).
        """
        if (block_budget is None) != (block_cost is None):
            # passing one without the other used to surface as a bare
            # TypeError deep in the accounting loop, after requests had
            # already been inspected — validate the pairing up front
            raise ValueError(
                "pop_group needs block_budget and block_cost together: "
                f"got block_budget={block_budget!r}, "
                f"block_cost={'None' if block_cost is None else 'set'} "
                "(paged planes supply both; contiguous planes neither)")
        if not self.queue or max_requests <= 0:
            return []
        plen = self.queue[0].prompt.size
        group: list[ServeRequest] = []
        tokens = 0
        blocks = 0
        for r in list(self.queue):
            if r.prompt.size != plen:
                continue
            if group and tokens + plen > token_budget:
                break
            if block_budget is not None:
                cost = block_cost(r)
                if blocks + cost > block_budget:
                    if not group:
                        return []  # head-of-line waits for block frees
                    break
                blocks += cost
            group.append(r)
            tokens += plen
            if len(group) >= max_requests:
                break
        for r in group:
            self.queue.remove(r)
            r.status = "active"
        return group

    # --------------------------------------------------------------- results
    def finish(self, req: ServeRequest, *, status: str = "ok") -> None:
        req.status = status
        req.finished_at = self.clock()
        self.done[req.rid] = req

    def results(self) -> dict[int, list[int]]:
        """rid → generated tokens, for every finished request."""
        return {rid: r.out for rid, r in self.done.items()}
