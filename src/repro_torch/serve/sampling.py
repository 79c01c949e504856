"""Sampling contract of the serving stack; greedy decoding only, so far.

The JAX package draws sampled tokens with request-keyed keys,
``fold_in(fold_in(PRNGKey(seed), rid), position)``, so a draw depends only
on ``(seed, rid, position, logits)``.  Torch cannot reproduce those draws, and
the port's own keyed sampler waits for ROADMAP.md queue 1, item 7.  Until
then the contract is checked here as in the JAX package, and any sampled
setting (temperature > 0, top_k, top_p) raises ``NotImplementedError`` at
config or submit time.  Greedy decoding is exact: the argmax of the raw
logits, the first index on ties, as ``jnp.argmax`` picks.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

#: disabled-filter sentinels
TOP_K_OFF = 0
TOP_P_OFF = 1.0

_SAMPLED = ("sampled decoding (temperature > 0, top_k, top_p) is not ported "
            "yet: the port serves greedy requests only (ROADMAP.md queue 1, "
            "item 7)")


@dataclasses.dataclass(frozen=True)
class SampleParams:
    """Per-request sampling contract, resolved + validated at submit time.

    ``temperature == 0`` is greedy, the only mode the port serves yet.
    """

    seed: int = 0
    temperature: float = 0.0
    top_k: int = TOP_K_OFF
    top_p: float = TOP_P_OFF

    def validate(self) -> "SampleParams":
        if not math.isfinite(self.temperature) or self.temperature < 0.0:
            raise ValueError(
                f"temperature must be finite and >= 0 (0 = greedy), got "
                f"{self.temperature}")
        if not 0 <= int(self.seed) < 2 ** 32:
            raise ValueError(f"seed must fit uint32, got {self.seed}")
        if self.top_k < 0:
            raise ValueError(
                f"top_k must be >= 1 ({TOP_K_OFF} = disabled), got "
                f"{self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1] ({TOP_P_OFF} = disabled), got "
                f"{self.top_p}")
        if (self.temperature > 0.0 or self.top_k != TOP_K_OFF
                or self.top_p != TOP_P_OFF):
            raise NotImplementedError(_SAMPLED)
        return self

    @classmethod
    def resolve(cls, serve, *, seed=None, temperature=None, top_k=None,
                top_p=None) -> "SampleParams":
        """Fill per-request overrides from the ``ServeConfig`` defaults and
        validate the result (the submit seam's half of the contract)."""
        return cls(
            seed=int(serve.sample_seed if seed is None else seed),
            temperature=float(serve.temperature if temperature is None
                              else temperature),
            top_k=int((TOP_K_OFF if serve.top_k is None else serve.top_k)
                      if top_k is None else top_k),
            top_p=float((TOP_P_OFF if serve.top_p is None else serve.top_p)
                        if top_p is None else top_p),
        ).validate()


def sample_rows(samples, dtype_len: int) -> tuple:
    """Host-side row arrays (seeds, temps, top_ks, top_ps) for ``dtype_len``
    lanes from a list of ``SampleParams`` (padded with greedy defaults)."""
    seeds = np.zeros((dtype_len,), np.uint32)
    temps = np.zeros((dtype_len,), np.float32)
    tks = np.full((dtype_len,), TOP_K_OFF, np.int32)
    tps = np.full((dtype_len,), TOP_P_OFF, np.float32)
    for i, s in enumerate(samples):
        seeds[i], temps[i], tks[i], tps[i] = s.seed, s.temperature, s.top_k, s.top_p
    return seeds, temps, tks, tps


def keyed_sample(logits, rids, seeds, positions, temps, top_ks, top_ps):
    """One token per lane from ``logits [B, V]``; the row arguments are the
    host-side ``[B]`` rows the JAX sampler takes.

    Every lane must be greedy (temperature 0, no filter): its token is the
    argmax of the raw logits, the first index on ties.
    """
    if (np.any(np.asarray(temps) > 0.0)
            or np.any(np.asarray(top_ks) != TOP_K_OFF)
            or np.any(np.asarray(top_ps) != TOP_P_OFF)):
        raise NotImplementedError(_SAMPLED)
    return torch.argmax(logits, dim=-1).to(torch.int32)
