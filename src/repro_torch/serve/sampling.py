"""Stateless request-keyed sampling: the index-batching principle for PRNGs.

The token at sequence position ``pos`` of request ``rid`` is drawn with

    key = fold_in(fold_in(PRNGKey(seed), rid), pos)

so a draw depends only on ``(seed, rid, pos, logits)``: not on plane
assignment, slot index, batch composition or any other request.  Positions
are absolute (the prompt occupies ``0..plen-1``; the first sampled token
sits at ``pos = plen``), so a restored request, re-prefilled from ``prompt +
generated prefix`` of length ``plen + g``, draws at ``pos = plen + g`` with
the very key the dead host would have used next.  Its logits come from a
prefill instead of a decode step, whose roundings differ: in float32 by
some ulps, in bf16 by up to a tenth on recurrentgemma's smoke config, in
the JAX package as in the port.  So a restored draw equals the
uninterrupted one in float32 unless two perturbed values lie within such a
margin, and in bf16 a near-tie draw can flip.

The keys and the uniform draws are the JAX package's bit for bit
(``repro_torch.serve.threefry``); there is no ``torch.Generator``.  The
filters run in the logits' dtype, rounded where the JAX package's are
(top-p's softmax and cumulative mass included), and a sampled lane takes the
argmax of ``filtered / temperature + gumbel`` (the first index on ties): the
float32 temperature row promotes the quotient to float32, so the gumbel
noise ``-log(-log(u))`` is float32 from 32-bit draws for every logits
dtype.  torch's and XLA's float32 ``log`` and ``exp`` differ by some ulps, so
a draw whose two largest perturbed values lie within such a margin may pick
the other token.  A temperature-0 lane returns the argmax of the raw
logits, as greedy decoding always did.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.distributed import is_dtensor, local_offset, wrap_local
from repro_torch.serve import threefry

#: disabled-filter sentinels (real no-op parameter values)
TOP_K_OFF = 0
TOP_P_OFF = 1.0
#: the block length of XLA's scan for a cumulative sum (see _cumsum_blocked)
_SCAN_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class SampleParams:
    """Per-request sampling contract, resolved + validated at submit time.

    ``seed`` is the request's base PRNG seed (folded with rid/position at
    draw time); ``top_k``/``top_p`` filter logits before the draw
    (``TOP_K_OFF``/``TOP_P_OFF`` disable).  ``temperature == 0`` is greedy
    regardless of the other fields.
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


def _row(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x).astype(np.int64), device=device)


def request_key(seed, rid, position) -> tuple[torch.Tensor, torch.Tensor]:
    """The draw keys for token ``position`` of request ``rid`` (int64
    tensors of 32-bit words, broadcast together): a pure function of
    indices, with no stream and nothing to restore."""
    return threefry.fold_in(threefry.fold_in(threefry.prng_key(seed), rid),
                            position)


def _filter_top_k(lg, k):
    """Mask logits below each row's k-th largest to -inf.  ``k <= 0``
    disables (effective k = vocab).  Ties at the k-th value are kept."""
    vocab = lg.shape[-1]
    eff = torch.where(k <= 0, vocab, torch.clamp(k, max=vocab))
    kth = torch.sort(lg, dim=-1, descending=True).values.gather(-1, (eff - 1)[:, None])
    return torch.where(lg >= kth, lg, -torch.inf)


def _cumsum_blocked(x):
    """Cumulative sum along the last dim in ``x``'s dtype, in the association
    XLA gives ``jnp.cumsum`` (a reduce-window rewritten as a blocked scan):
    blocks of 16 summed in order, the block totals scanned the same way and
    added to each block, every add rounded to the dtype.  In bf16 that
    association decides where a long tail's mass stops growing, and so where
    top-p cuts."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, dim=-1)
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    local = _cumsum_blocked(blocks.reshape(*x.shape[:-1], nb, _SCAN_BLOCK))
    totals = _cumsum_blocked(local[..., -1])
    before = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (before[..., None] + local).reshape(*x.shape[:-1], -1)[..., :n]


def _filter_top_p(lg, p):
    """Nucleus filter: keep each row's smallest descending-probability prefix
    whose cumulative mass reaches ``p`` (the first index reaching it is
    inclusive, so at least one token stays).  The softmax and the mass are
    in ``lg``'s dtype, rounded as the JAX package's: the shifted logits and
    the exponentials in the dtype, their sum in float32, the quotient and
    every partial sum of the mass in the dtype."""
    desc = torch.sort(lg, dim=-1, descending=True).values
    ex = torch.exp((desc - desc[:, :1]).float())
    total = ex.sum(dim=-1, keepdim=True).to(lg.dtype)
    cum = _cumsum_blocked(ex.to(lg.dtype) / total)
    keep = torch.clamp(torch.sum(cum.float() < p[:, None], dim=-1) + 1, max=lg.shape[-1])
    thresh = desc.gather(-1, (keep - 1)[:, None])
    return torch.where(lg >= thresh, lg, -torch.inf)


def perturbed(logits, rids, seeds, positions, temps, top_ks, top_ps):
    """``filtered / temperature + gumbel`` in float32 for lanes that all
    sample (temperature > 0): the values whose argmax is each lane's token.
    The rows are host arrays; ``logits`` is ``[B, V]`` on any device."""
    dev = logits.device
    filt = _filter_top_p(_filter_top_k(logits, _row(top_ks, dev)),
                         torch.as_tensor(np.asarray(top_ps, np.float32), device=dev))
    key = request_key(_row(seeds, dev), _row(rids, dev), _row(positions, dev))
    gumbel = -torch.log(-torch.log(threefry.uniform(key, logits.shape[-1])))
    t = torch.as_tensor(np.asarray(temps, np.float32), device=dev)[:, None]
    return filt.float() / t + gumbel


def keyed_sample(logits, rids, seeds, positions, temps, top_ks, top_ps):
    """Sample one token per lane from ``logits [B, V]`` with request-keyed
    draws.  The row arguments are the host-side ``[B]`` rows; every output
    depends only on its own lane's ``(seed, rid, position, logits)``.

    A ``temperature == 0`` lane returns ``argmax`` of the RAW logits (filters
    never touch it).  Only the sampled lanes pay for the filters and the
    draw, and a step with none is one argmax, as greedy decoding was.

    DTensor logits (a sharded plane's, the vocabulary split over ``model``)
    are redistributed to whole rows, the lanes split as they were over the
    data axes; each rank draws its own lanes from their whole rows, and the
    tokens come back as a DTensor split as those lanes are.  A draw is a
    pure function of its lane's row arguments, so no rank changes a token.
    """
    if is_dtensor(logits):
        return _sample_on_shards(logits, rids, seeds, positions, temps, top_ks, top_ps)
    toks = torch.argmax(logits, dim=-1).to(torch.int32)
    sampled = np.flatnonzero(np.asarray(temps) > 0.0)
    if sampled.size:
        rows = (np.asarray(r)[sampled] for r in (rids, seeds, positions, temps,
                                                 top_ks, top_ps))
        idx = torch.as_tensor(sampled, device=logits.device)
        drawn = torch.argmax(perturbed(logits[idx], *rows), dim=-1)
        toks[idx] = drawn.to(torch.int32)
    return toks


def _sample_on_shards(logits, *rows):
    from torch.distributed.tensor import Replicate, Shard

    mesh = logits.device_mesh
    lanes = [p if p == Shard(0) else Replicate() for p in logits.placements]
    logits = logits.redistribute(mesh, lanes)
    lo = local_offset(logits, 0)
    local = logits.to_local()
    n = local.shape[0]
    toks = keyed_sample(local, *(np.asarray(r)[lo:lo + n] for r in rows))
    return wrap_local(toks, mesh, lanes, (logits.shape[0],))
