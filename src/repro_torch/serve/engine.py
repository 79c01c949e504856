"""ServeEngine: Router + InferencePlane fleet, the serving engine.

The ``Router`` owns admission (backpressure, deadlines, prompt-length
grouping), each ``InferencePlane`` owns one slot pool, and the engine is the
step loop that moves requests between them:

    step():  expire deadlines → batched-prefill queued requests into free
             lanes (least-loaded plane first) → one batched decode step per
             plane with live lanes → retire budget/EOS/full/deadline lanes.

Output equals the reference ``repro_torch.serve.Server``'s at any
temperature: decode and the request-keyed draws (``serve.sampling``) are per
lane pure functions of each request, so neither the prefill grouping, the
plane assignment nor the cache layout may change what any request generates.
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig
from repro_torch.serve.plane import (InferencePlane, PagedInferencePlane, place_params,
                                     realise_mesh)
from repro_torch.serve.router import Router, ServeRequest
from repro_torch.serve.server import ServeConfig, validate_request


class ServeEngine:
    """Continuous-batching engine over one or more slot pools, on one device
    or sharded over a (data × model) ``mesh`` (``InferencePlane``).

    The engine makes the compute-dtype copy of the weights once (on a mesh:
    realises the mesh and places the copy's shards once), so its N planes
    share one mesh and one set of weight tensors.  ``serve.block_size`` selects
    the plane flavour: None builds contiguous ``InferencePlane`` pools; a
    block size builds ``PagedInferencePlane`` pools, and admission accounts
    pool BLOCKS (through ``Router.pop_group``'s block budget) on top of free
    lanes, so a full pool backpressures at the router instead of running
    the device out of memory in a prefill.
    """

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 planes: int = 1, mesh=None, queue_limit: int | None = None,
                 prefill_token_budget: int | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: str | torch.device = "cuda"):
        self.serve = serve
        self.paged = serve.block_size is not None
        #: default backpressure bound: 4 waves of the whole fleet
        if queue_limit is None:
            queue_limit = 4 * planes * serve.slots
        self.router = Router(serve, queue_limit=queue_limit, clock=clock)
        self.prefill_token_budget = (prefill_token_budget
                                     or max(serve.max_len, 512))
        device = resolve_device(device)
        shared = lm.compute_copy(params, cfg, device)
        if mesh is not None:
            mesh = realise_mesh(mesh, device)
            shared = place_params(shared, cfg, mesh, device)
        plane_cls = PagedInferencePlane if self.paged else InferencePlane
        self.planes = [plane_cls(shared, cfg, serve, mesh=mesh, device=device)
                       for _ in range(planes)]
        self.active: list[list[ServeRequest | None]] = [
            [None] * serve.slots for _ in self.planes]

    # ------------------------------------------------------------------ queue
    def submit(self, prompt_tokens, *, max_new_tokens: int | None = None,
               deadline_s: float | None = None, seed: int | None = None,
               temperature: float | None = None, top_k: int | None = None,
               top_p: float | None = None, rid: int | None = None) -> int:
        """Admit a request (raises ``Backpressure`` / ``ValueError``).

        ``seed``/``temperature``/``top_k``/``top_p`` override the config's
        sampling defaults for this request; ``rid`` pins the request id (the
        fleet worker passes the COORDINATOR's rid so keyed draws survive
        re-placement).  Paged pools add one admission rule: a request whose
        lifetime block cost exceeds the POOL's capacity can never run and is
        rejected with ``ValueError`` here (a full-but-draining pool is the
        router's block accounting's business instead).
        """
        if self.paged:
            prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
            budget = validate_request(self.serve, prompt, max_new_tokens)
            plane = self.planes[0]
            need = plane.block_cost(prompt.size, budget)
            if need > plane.pool.num_blocks:
                raise ValueError(
                    f"request needs {need} blocks; the pool only has "
                    f"{plane.pool.num_blocks}: raise pool_blocks or shorten "
                    f"the request")
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

        # admission: batched prefill into free lanes, least-loaded plane
        # first; a plane whose BLOCK pool can't take the group's leader is
        # skipped (another plane may have the blocks)
        while self.router.queue:
            order = sorted(((len(p.free_slots()), pi)
                            for pi, p in enumerate(self.planes)), reverse=True)
            popped = False
            for n_free, pi in order:
                if n_free == 0:
                    continue
                plane = self.planes[pi]
                if self.paged:
                    group = self.router.pop_group(
                        n_free, self.prefill_token_budget,
                        block_budget=plane.free_blocks(),
                        block_cost=lambda r, p=plane: p.block_cost(
                            r.prompt.size, r.budget))
                else:
                    group = self.router.pop_group(n_free,
                                                  self.prefill_token_budget)
                if not group:
                    continue
                slots = plane.free_slots()[:len(group)]
                prompts = np.stack([r.prompt for r in group])
                toks = plane.prefill_into(slots, prompts,
                                          budgets=[r.budget for r in group],
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
                popped = True
                break
            if not popped:
                break

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

    # ------------------------------------------------------------------ stats
    def occupancy(self) -> float:
        """Live-lane fraction of the fleet's slot pool, 0..1."""
        total = len(self.planes) * self.serve.slots
        return self.active_lanes() / total if total else 0.0
