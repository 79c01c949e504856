"""InferencePlane: one device's slot pool, the device half of the engine.

A plane owns every device-resident object (the compute-dtype weights, the
slot-pool cache) for one pool; the engine above it only moves token ids and
bookkeeping.  The port's plane lives on one device: the JAX package's
(data × model) mesh and its ``PagedInferencePlane`` wait for later slices
(ROADMAP.md queue 1, item 7), and a mesh raises here.

- ``decode``: one batched decode step over all ``slots`` lanes, retired
  lanes included (their length is 0; their recurrent state, conv tail and
  ring are replaced whole at the next scatter, as in the JAX package).
- ``prefill_into``: BATCHED prefill: ``[k, plen]`` prompts through one
  forward that fills its own k-batch cache, then one ``scatter_cache``
  writes all k lanes into the pool.

One-pull-per-step invariant: decode bookkeeping (lengths, next tokens,
sampling rows) is host-resident numpy, uploaded as arguments; the only
blocking device→host sync per decode step (and per prefill group) is the
single ``common.device_get`` of the sampled token row.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig
from repro_torch.serve import common, sampling
from repro_torch.serve.server import ServeConfig
from repro_torch.tree import tree_leaves


class InferencePlane:
    """Slot pool + batched prefill/decode on one device."""

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 mesh=None, device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "sharded planes are not ported yet: the port's InferencePlane "
                "runs on one device (ROADMAP.md queue 1, item 7)")
        self.cfg = cfg
        self.serve = serve
        self.device = resolve_device(device)
        # a tree already in the compute dtype on this device is shared as is
        self.params = lm.compute_copy(params, cfg, self.device)

        b, s = serve.slots, serve.max_len
        self.cache = lm.init_cache(cfg, b, s, self.device)
        # host-resident decode bookkeeping: uploaded as arguments, never pulled
        self.lengths = np.zeros((b,), np.int32)
        self.tokens = np.zeros((b, 1), np.int32)
        self.rids = np.zeros((b,), np.int32)
        self.seeds = np.zeros((b,), np.uint32)
        self.temps = np.zeros((b,), np.float32)
        self.top_ks = np.full((b,), sampling.TOP_K_OFF, np.int32)
        self.top_ps = np.full((b,), sampling.TOP_P_OFF, np.float32)

    # ---------------------------------------------------------------- sampling
    def _set_sample_rows(self, slots: list[int], rids, samples) -> tuple:
        """Record each slot's (rid, SampleParams) and return the GROUP row
        arrays for the prefill draw.  ``rids``/``samples`` default to rid 0 /
        greedy."""
        k = len(slots)
        if rids is None:
            rids = [0] * k
        if samples is None:
            samples = [sampling.SampleParams()] * k
        seeds, temps, tks, tps = sampling.sample_rows(samples, k)
        grids = np.asarray(rids, np.int32)
        for i, slot in enumerate(slots):
            self.rids[slot] = grids[i]
            self.seeds[slot] = seeds[i]
            self.temps[slot] = temps[i]
            self.top_ks[slot] = tks[i]
            self.top_ps[slot] = tps[i]
        return grids, seeds, temps, tks, tps

    # ------------------------------------------------------------------ lanes
    def free_slots(self) -> list[int]:
        """Lanes with no resident sequence (length 0 = masked/never filled)."""
        return [i for i in range(self.serve.slots) if self.lengths[i] == 0]

    def cache_bytes(self) -> int:
        """Resident device bytes of this plane's cache."""
        return sum(leaf.nbytes for leaf in tree_leaves(self.cache))

    def prefill_into(self, slots: list[int], prompts: np.ndarray,
                     rids: list[int] | None = None,
                     samples=None) -> np.ndarray:
        """Batched prefill of ``[k, plen]`` prompts into ``slots`` (len k).

        Returns the k first tokens (host).  One device->host pull for the
        group.
        """
        if prompts.ndim != 2 or prompts.shape[0] != len(slots):
            raise ValueError(f"prompts must be [len(slots), plen], got "
                             f"{prompts.shape} for {len(slots)} slots")
        k, plen = prompts.shape
        grids, seeds, temps, tks, tps = self._set_sample_rows(slots, rids,
                                                              samples)
        sub = lm.init_cache(self.cfg, k, self.serve.max_len, self.device)
        logits, sub, _ = lm.prefill(self.params, self.cfg,
                                    common.to_device(prompts, self.device), sub)
        positions = np.full((k,), plen, np.int32)  # prompt occupies 0..plen-1
        toks = common.device_get(sampling.keyed_sample(
            logits, grids, seeds, positions, temps, tks, tps))
        lm.scatter_cache(self.cache, sub, slots)
        for i, slot in enumerate(slots):
            self.lengths[slot] = plen
            self.tokens[slot, 0] = toks[i]
        return toks

    def decode(self) -> np.ndarray:
        """One batched decode step over the pool.  Returns the sampled token
        row (host, [slots]): the step's single device→host pull."""
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, common.to_device(self.tokens, self.device),
            self.cache, common.to_device(self.lengths, self.device))
        return common.device_get(sampling.keyed_sample(
            logits, self.rids, self.seeds, self.lengths + np.int32(1),
            self.temps, self.top_ks, self.top_ps))

    def advance(self, slot: int, tok: int) -> None:
        """Commit a decode step's token on a live lane."""
        self.lengths[slot] += 1
        self.tokens[slot, 0] = tok

    def release(self, slot: int) -> None:
        """Retire a lane: mask its token/length so later decode steps never
        read its stale state (the cache slice is replaced at next prefill)."""
        self.lengths[slot] = 0
        self.tokens[slot, 0] = 0
        self.rids[slot] = 0
        self.seeds[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = sampling.TOP_K_OFF
        self.top_ps[slot] = sampling.TOP_P_OFF
