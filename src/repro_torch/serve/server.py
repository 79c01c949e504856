"""Single-host continuous-batching server over a fixed slot pool.

Weights and caches are resident on the device; the host only ships token
ids.  ``Server`` keeps ``slots`` decode lanes; finished lanes are refilled
from the request queue via single-request prefill into the shared cache.

This is the REFERENCE implementation: one lane prefilled at a time, tokens
held equal to the JAX package's ``Server`` by the tests, greedy and sampled.
The engine (``repro_torch.serve.engine.ServeEngine``) batches prefill and may
page its caches; its output is held equal to this server at any temperature.

Decode bookkeeping (lengths, last tokens, lane occupancy) lives on the HOST:
the only blocking device→host sync per decode step is the single
``device_get`` of the sampled token row.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig
from repro_torch.serve import common, sampling
from repro_torch.serve.sampling import SampleParams
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4  # concurrent decode lanes
    max_len: int = 256  # cache capacity per lane
    max_new_tokens: int = 32
    #: default per-request sampling contract (each submit may override):
    #: draws are request-keyed, ``fold_in(fold_in(key(seed), rid), pos)``,
    #: so they never depend on plane/slot/batch placement
    temperature: float = 0.0  # 0 = greedy
    sample_seed: int = 0  # default per-request base seed
    top_k: int | None = None  # keep the k largest logits (None = off)
    top_p: float | None = None  # nucleus mass cutoff in (0, 1] (None = off)
    eos_id: int | None = None
    #: paged KV: tokens per cache block (None = contiguous per-slot lines).
    #: The reference Server ignores it; it stays the contiguous anchor.
    block_size: int | None = None
    #: usable blocks in the shared pool; None = slots * ceil(max_len /
    #: block_size), contiguous capacity at block granularity.  Size it to the
    #: EXPECTED live tokens (prompt + budget per request x slots) for the
    #: memory win; admission accounts blocks and backpressures when the pool
    #: is exhausted.
    pool_blocks: int | None = None

    def __post_init__(self):
        # reject bad sampling defaults at CONFIG time, before a request ever
        # rides on them
        sampling.SampleParams(seed=self.sample_seed,
                              temperature=self.temperature,
                              top_k=(sampling.TOP_K_OFF if self.top_k is None
                                     else self.top_k),
                              top_p=(sampling.TOP_P_OFF if self.top_p is None
                                     else self.top_p)).validate()

    def pool_capacity(self) -> int:
        """Usable blocks in the paged pool (0 when not paged)."""
        if self.block_size is None:
            return 0
        if self.pool_blocks is not None:
            return self.pool_blocks
        return self.slots * (-(-self.max_len // self.block_size))


def validate_request(serve: ServeConfig, prompt: np.ndarray,
                     max_new_tokens: int | None) -> int:
    """Resolve + validate a request's token budget.  Returns the budget.

    ``max_new_tokens`` compares against ``None`` (an explicit 0 is NOT "use
    the default": it is rejected).  ``len(prompt) + budget`` must fit the
    lane's ``max_len`` cache.
    """
    budget = serve.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
    if budget < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {budget}")
    if prompt.ndim != 1 or prompt.size == 0:
        raise ValueError(f"prompt must be a non-empty 1-D token array, "
                         f"got shape {prompt.shape}")
    if prompt.size + budget > serve.max_len:
        raise ValueError(
            f"prompt ({prompt.size} tokens) + max_new_tokens ({budget}) "
            f"exceeds max_len ({serve.max_len}); shorten the prompt or "
            f"raise ServeConfig.max_len")
    return budget


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    out: list[int] = dataclasses.field(default_factory=list)
    budget: int = 0
    sample: SampleParams = dataclasses.field(default_factory=SampleParams)


class Server:
    """Continuous-batching server around prefill/decode_step, on ``device``
    (the card unless the caller asks for the CPU)."""

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = lm.compute_copy(params, cfg, self.device)
        self.cfg = cfg
        self.serve = serve
        self.queue: deque[_Request] = deque()
        self.done: dict[int, list[int]] = {}
        self._next_rid = 0

        b, s = serve.slots, serve.max_len
        self.cache = lm.init_cache(cfg, b, s, self.device)
        # host-resident bookkeeping: uploaded as decode arguments, never
        # pulled back per lane
        self.lengths = np.zeros((b,), np.int32)
        self.tokens = np.zeros((b, 1), np.int32)
        self.active: list[_Request | None] = [None] * b
        self.rids = np.zeros((b,), np.int32)
        self.seeds = np.zeros((b,), np.uint32)
        self.temps = np.zeros((b,), np.float32)
        self.top_ks = np.full((b,), sampling.TOP_K_OFF, np.int32)
        self.top_ps = np.full((b,), sampling.TOP_P_OFF, np.float32)

    # ------------------------------------------------------------------ queue
    def submit(self, prompt_tokens: np.ndarray, *,
               max_new_tokens: int | None = None, seed: int | None = None,
               temperature: float | None = None, top_k: int | None = None,
               top_p: float | None = None) -> int:
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        budget = validate_request(self.serve, prompt, max_new_tokens)
        sample = SampleParams.resolve(self.serve, seed=seed,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(_Request(rid, prompt, budget=budget, sample=sample))
        return rid

    def _fill_slot(self, slot: int) -> bool:
        """Prefill queued requests into ``slot`` until one survives.

        A request can retire AT the prefill token (budget met, or the first
        token is EOS): it must never occupy a decode lane.
        """
        while self.queue:
            req = self.queue.popleft()
            # single-lane prefill into a fresh 1-batch cache, then scatter
            cache1 = lm.init_cache(self.cfg, 1, self.serve.max_len, self.device)
            logits, cache1, _ = lm.prefill(
                self.params, self.cfg, common.to_device(req.prompt[None], self.device),
                cache1)
            tok = int(common.device_get(self._sample(
                logits, [req], positions=np.array([req.prompt.size],
                                                  np.int32)))[0])
            req.out.append(tok)
            hit_eos = self.serve.eos_id is not None and tok == self.serve.eos_id
            if len(req.out) >= req.budget or hit_eos:
                self.done[req.rid] = req.out  # retired at prefill; slot stays free
                continue

            # stage-stacked caches: [repeats, ...] with batch at axis 1
            tree_map(lambda big, small: big[:, slot].copy_(small[:, 0]),
                     self.cache, cache1)
            self.lengths[slot] = req.prompt.size  # prefill length, known on host
            self.tokens[slot, 0] = tok
            self.active[slot] = req
            self.rids[slot] = req.rid
            self.seeds[slot] = req.sample.seed
            self.temps[slot] = req.sample.temperature
            self.top_ks[slot] = req.sample.top_k
            self.top_ps[slot] = req.sample.top_p
            return True
        return False

    def _sample(self, logits, reqs: list[_Request], positions: np.ndarray):
        """Draws for an ad-hoc row of requests (prefill)."""
        seeds, temps, tks, tps = sampling.sample_rows(
            [r.sample for r in reqs], len(reqs))
        rids = np.array([r.rid for r in reqs], np.int32)
        return sampling.keyed_sample(logits, rids, seeds, positions, temps,
                                     tks, tps)

    def _sample_pool(self, logits):
        """Draws for the whole slot pool (decode): the token being sampled
        sits at position length + 1."""
        return sampling.keyed_sample(logits, self.rids, self.seeds,
                                     self.lengths + np.int32(1), self.temps,
                                     self.top_ks, self.top_ps)

    # ------------------------------------------------------------------- step
    def step(self) -> int:
        """Refill free slots, run one batched decode step.  Returns #active."""
        for slot in range(self.serve.slots):
            if self.active[slot] is None:
                if not self._fill_slot(slot):
                    break
        if not any(r is not None for r in self.active):
            return 0
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, common.to_device(self.tokens, self.device),
            self.cache, common.to_device(self.lengths, self.device))
        # the step's ONE device→host sync: the whole sampled token row
        next_tok = common.device_get(self._sample_pool(logits))
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            self.lengths[slot] += 1
            tok = int(next_tok[slot])
            self.tokens[slot, 0] = tok  # next step's input for this lane
            req.out.append(tok)
            hit_eos = self.serve.eos_id is not None and tok == self.serve.eos_id
            full = self.lengths[slot] >= self.serve.max_len - 1
            if len(req.out) >= req.budget or hit_eos or full:
                self.done[req.rid] = req.out
                self.active[slot] = None
                # mask the retired lane: its length resets, and its cache
                # slice is overwritten whole at the next prefill
                self.lengths[slot] = 0
                self.tokens[slot, 0] = 0
                self.rids[slot] = 0
                self.seeds[slot] = 0
                self.temps[slot] = 0.0
                self.top_ks[slot] = sampling.TOP_K_OFF
                self.top_ps[slot] = sampling.TOP_P_OFF
        return sum(1 for r in self.active if r is not None)

    def run(self) -> dict[int, list[int]]:
        """Drain the queue to completion."""
        while self.queue or any(r is not None for r in self.active):
            self.step()
        return self.done
