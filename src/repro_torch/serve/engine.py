"""ServeEngine: Router + InferencePlane fleet, the serving engine.

The ``Router`` owns admission (backpressure, deadlines, prompt-length
grouping), each ``InferencePlane`` owns one slot pool, and the engine is the
step loop that moves requests between them:

    step():  expire deadlines → batched-prefill queued requests into free
             lanes (least-loaded plane first) → one batched decode step per
             plane with live lanes → retire budget/EOS/full/deadline lanes.

Greedy output equals the reference ``repro_torch.serve.Server``'s: decode is
per lane, so neither the prefill grouping nor the plane assignment may change
what any request generates.  Planes are contiguous; a ``block_size`` (paged
planes) raises until the paged plane is ported.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig
from repro_torch.serve.plane import InferencePlane
from repro_torch.serve.router import Router, ServeRequest
from repro_torch.serve.server import ServeConfig


class ServeEngine:
    """Continuous-batching engine over one or more slot pools on one device.

    The engine makes the compute-dtype copy of the weights once, so its N
    planes share one set of weight tensors.
    """

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 planes: int = 1, mesh=None, queue_limit: int | None = None,
                 prefill_token_budget: int | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: str | torch.device = "cuda"):
        if serve.block_size is not None:
            raise NotImplementedError(
                "paged planes (ServeConfig.block_size) are not ported yet "
                "(ROADMAP.md queue 1, item 7)")
        self.serve = serve
        #: default backpressure bound: 4 waves of the whole fleet
        if queue_limit is None:
            queue_limit = 4 * planes * serve.slots
        self.router = Router(serve, queue_limit=queue_limit, clock=clock)
        self.prefill_token_budget = (prefill_token_budget
                                     or max(serve.max_len, 512))
        device = resolve_device(device)
        shared = lm.compute_copy(params, cfg, device)
        self.planes = [InferencePlane(shared, cfg, serve, mesh=mesh, device=device)
                       for _ in range(planes)]
        self.active: list[list[ServeRequest | None]] = [
            [None] * serve.slots for _ in self.planes]

    # ------------------------------------------------------------------ queue
    def submit(self, prompt_tokens, *, max_new_tokens: int | None = None,
               deadline_s: float | None = None, seed: int | None = None,
               temperature: float | None = None, top_k: int | None = None,
               top_p: float | None = None, rid: int | None = None) -> int:
        """Admit a request (raises ``Backpressure`` / ``ValueError``, and
        ``NotImplementedError`` for a sampled request)."""
        return self.router.submit(prompt_tokens, max_new_tokens=max_new_tokens,
                                  deadline_s=deadline_s, seed=seed,
                                  temperature=temperature, top_k=top_k,
                                  top_p=top_p, rid=rid)

    # ------------------------------------------------------------ bookkeeping
    def _retire(self, pi: int, slot: int, req: ServeRequest, *,
                status: str = "ok") -> None:
        self.router.finish(req, status=status)
        self.active[pi][slot] = None
        self.planes[pi].release(slot)

    def _should_retire(self, req: ServeRequest, tok: int) -> bool:
        hit_eos = (self.serve.eos_id is not None and tok == self.serve.eos_id)
        return len(req.out) >= req.budget or hit_eos

    def active_lanes(self) -> int:
        return sum(1 for pool in self.active for r in pool if r is not None)

    # ------------------------------------------------------------------- step
    def step(self) -> int:
        """One engine tick.  Returns live lanes + queued requests."""
        self.router.expire()
        # deadline sweep over live lanes: a request past its deadline must
        # release the lane NOW; holding it starves queued requests
        for pi, pool in enumerate(self.active):
            for slot, req in enumerate(pool):
                if req is not None and self.router.past_deadline(req):
                    self._retire(pi, slot, req, status="timeout")

        # admission: batched prefill into free lanes, least-loaded plane first
        while self.router.queue:
            order = sorted(((len(p.free_slots()), pi)
                            for pi, p in enumerate(self.planes)), reverse=True)
            n_free, pi = order[0]
            if n_free == 0:
                break
            plane = self.planes[pi]
            group = self.router.pop_group(n_free, self.prefill_token_budget)
            slots = plane.free_slots()[:len(group)]
            prompts = np.stack([r.prompt for r in group])
            toks = plane.prefill_into(slots, prompts,
                                      rids=[r.rid for r in group],
                                      samples=[r.sample for r in group])
            for req, slot, tok in zip(group, slots, toks):
                req.out.append(int(tok))
                if self._should_retire(req, int(tok)):
                    # retired AT the prefill token (budget 1 / EOS first):
                    # the lane frees immediately for this same step
                    self._retire(pi, slot, req)
                else:
                    self.active[pi][slot] = req

        # one batched decode step per plane with live lanes
        for pi, (plane, pool) in enumerate(zip(self.planes, self.active)):
            lanes = [s for s, r in enumerate(pool) if r is not None]
            if not lanes:
                continue
            tok_row = plane.decode()
            for slot in lanes:
                req = pool[slot]
                tok = int(tok_row[slot])
                plane.advance(slot, tok)
                req.out.append(tok)
                full = plane.lengths[slot] >= self.serve.max_len - 1
                if self._should_retire(req, tok):
                    self._retire(pi, slot, req)
                elif full:
                    # the cache filled before the budget was spent
                    self._retire(pi, slot, req, status="truncated")
        return self.active_lanes() + len(self.router.queue)

    def run(self) -> dict[int, list[int]]:
        """Drain queue + lanes to completion.  rid → generated tokens."""
        while self.step():
            pass
        return self.router.results()
