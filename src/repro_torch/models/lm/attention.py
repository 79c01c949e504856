"""Attention variants: GQA/MQA full attention, blockwise (flash-style) online
softmax for long sequences, banded attention for sliding-window (SWA/local),
and single-step decode against a KV cache.

KV heads are never materialised ``G×``: scores are computed grouped
([B, Hkv, G, Sq, Skv]), so MQA reads each KV element once.  Scores and the
softmax are float32; the probabilities are cast to ``v``'s dtype before the
PV product, as in the JAX package.  The JAX ``lax.map``/``lax.scan`` over
chunks are Python loops here.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.distributed import (as_dtensor, is_dtensor, local_offset,
                                          model_dims, wrap_local)
from repro_torch.loops import trips

NEG_INF = -1e30


def _grouped(q, n_kv):
    b, s, h, d = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d)


def zero_pad(x, dim: int, before: int = 0, after: int = 0):
    """``x`` with ``before`` and ``after`` zero rows along ``dim``: what
    ``F.pad`` gives, as one ``cat`` (torch 2.11's DTensor rule for
    ``constant_pad_nd`` fails, so the dry-run's sharded cells need this
    form; the values are the same)."""
    shape = list(x.shape)
    parts = []
    for n in (before, after):
        shape[dim] = n
        parts.append(x.new_zeros(shape) if n else None)
    return torch.cat([t for t in (parts[0], x, parts[1]) if t is not None], dim=dim)


def _layout(rows, h: int, n_kv: int, seq_split=()):
    """Placements under which attention runs on each rank's shards, as
    ``(q placements, k/v placements)``: the batch split of ``rows`` (q, or
    the decode cache, whose lanes decide) is kept; a mesh dim in
    ``seq_split`` keeps the keys split along the sequence (q whole there);
    a ``model`` dim splits the heads when every rank then holds whole kv
    groups (the kv head count divides the dim, or there is one kv head,
    which every rank keeps); anything else is whole."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = rows.device_mesh
    tp = model_dims(mesh)
    pq, pkv = [], []
    for i, p in enumerate(rows.placements):
        n = mesh.size(i)
        if p == Shard(0):
            pq.append(p)
            pkv.append(p)
        elif i in seq_split:
            pq.append(Replicate())
            pkv.append(Shard(1))
        elif i in tp and h % n == 0 and (n_kv % n == 0 or n_kv == 1):
            pq.append(Shard(2))
            pkv.append(Shard(2) if n_kv % n == 0 else Replicate())
        else:
            pq.append(Replicate())
            pkv.append(Replicate())
    return pq, pkv


def _on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` for DTensor operands, run by every rank on its
    own batch rows and heads (both independent) and wrapped back with the
    same placements: the SPMD form of the einsums, which torch 2.11's
    DTensor cannot fold when a head dim is split."""
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    pq, pkv = _layout(q, q.shape[2], k.shape[2])
    out = fn(q.redistribute(mesh, pq).to_local(), k.redistribute(mesh, pkv).to_local(),
             v.redistribute(mesh, pkv).to_local(), **kw)
    return wrap_local(out, mesh, pq, tuple(q.shape[:3]) + (out.shape[3],))


def full_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                   q_offset: int = 0, kv_valid_from: int = 0, scale: float | None = None):
    """q: [B, Sq, H, D], k/v: [B, Skv, Hkv, D] -> [B, Sq, H, D].

    ``q_offset``: position of q[0] relative to k[0] (decode / banded chunks).
    ``kv_valid_from``: keys below this index are masked (padding).
    ``scale``: the softmax scale (None: ``1 / sqrt(D)``, as a division).
    Materialises the [Sq, Skv] score matrix; :func:`blockwise_attention`
    is for long sequences.  DTensor operands run on each rank's shards.
    """
    if is_dtensor(q) or is_dtensor(k):
        return _on_shards(full_attention, q, k, v, causal=causal, window=window,
                          q_offset=q_offset, kv_valid_from=kv_valid_from, scale=scale)
    b, sq, h, d = q.shape
    n_kv = k.shape[2]
    qg = _grouped(q, n_kv)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    qpos = q_offset + torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = kpos >= kv_valid_from
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, d)


def _chunks(n: int, size: int) -> list[tuple[int, int]]:
    """``(lo, hi)`` of consecutive chunks of ``size`` covering ``n``, the
    last one shorter where ``size`` does not divide ``n``."""
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _block_mask(q_lo, q_hi, k_lo, k_hi, causal, window, dev):
    """[q_hi - q_lo, k_hi - k_lo] bool: the keys each query of the block sees."""
    qpos = torch.arange(q_lo, q_hi, device=dev)[:, None]
    kpos = torch.arange(k_lo, k_hi, device=dev)[None, :]
    mask = torch.ones((q_hi - q_lo, k_hi - k_lo), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _block_seen(q_lo, q_hi, k_lo, k_hi, causal, window) -> bool:
    """Whether any query of ``[q_lo, q_hi)`` sees any key of ``[k_lo, k_hi)``.
    A block no query sees adds exactly nothing to the online softmax (its
    probabilities are 0 and its correction 1), so it may be skipped."""
    if causal and k_lo > q_hi - 1:
        return False
    if window is not None and k_hi - 1 <= q_lo - window:
        return False
    return True


def _online_softmax(q, k, v, causal, window, q_chunk, kv_chunk, scale, *, skip: bool):
    """The blockwise forward: ``(out, m, l)``, the output in ``q``'s dtype
    and each query's running max ``m`` and sum ``l`` ([B, S, Hkv, G],
    float32).  ``skip``: leave out the blocks no query sees (exact; the
    kv loop then is no longer alike trip by trip, so it is not marked for
    rolling)."""
    b, s, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    dv = v.shape[-1]
    dev = q.device
    outs, ms, ls = [], [], []
    kv = _chunks(k.shape[1], kv_chunk)
    for q_lo, q_hi in _chunks(s, q_chunk):
        qc = q_hi - q_lo
        qg = _grouped(q[:, q_lo:q_hi], n_kv).float()
        m = torch.full((b, qc, n_kv, g), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, qc, n_kv, g), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, qc, n_kv, g, dv), dtype=torch.float32, device=dev)
        for ki in range(len(kv)) if skip else trips(len(kv)):
            k_lo, k_hi = kv[ki]
            if skip and not _block_seen(q_lo, q_hi, k_lo, k_hi, causal, window):
                continue
            k_blk = k[:, k_lo:k_hi]
            v_blk = v[:, k_lo:k_hi]
            s_blk = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_blk.float()) * scale
            mask5 = _block_mask(q_lo, q_hi, k_lo, k_hi, causal, window, dev)[
                None, :, None, None, :]
            s_blk = torch.where(mask5, s_blk, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s_blk, dim=-1))
            # exp(NEG_INF - NEG_INF) would be 1 for fully-masked rows: zero them.
            p = torch.where(mask5, torch.exp(s_blk - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p, v_blk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.reshape(b, qc, h, dv).to(q.dtype))
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=1), torch.cat(ms, dim=1), torch.cat(ls, dim=1)


class _BlockwiseAttention(torch.autograd.Function):
    """Blockwise attention whose backward recomputes each query chunk's
    scores block by block from the saved running max and sum, so the live
    scores are one ``[q_chunk, kv_chunk]`` block in the backward as in the
    forward (the JAX version's ``jax.checkpoint`` recomputes the chunk)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk, scale):
        out, m, l = _online_softmax(q, k, v, causal, window, q_chunk, kv_chunk, scale,
                                    skip=True)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_chunk, kv_chunk, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_chunk, kv_chunk, scale = ctx.args
        b, s, h, d = q.shape
        n_kv = k.shape[2]
        g = h // n_kv
        dv = v.shape[-1]
        dev = q.device
        dq = torch.zeros((b, s, n_kv, g, d), dtype=torch.float32, device=dev)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=dev)
        dvv = torch.zeros(v.shape, dtype=torch.float32, device=dev)
        do = _grouped(dout, n_kv).float()  # [B, S, Hkv, G, Dv]
        # D_i = sum_j P_ij dP_ij = dO_i . O_i
        delta = torch.sum(do * _grouped(out, n_kv).float(), dim=-1)
        kv = _chunks(k.shape[1], kv_chunk)
        for q_lo, q_hi in _chunks(s, q_chunk):
            qg = _grouped(q[:, q_lo:q_hi], n_kv).float()
            do_c, lse_c, delta_c = do[:, q_lo:q_hi], lse[:, q_lo:q_hi], delta[:, q_lo:q_hi]
            for k_lo, k_hi in kv:
                if not _block_seen(q_lo, q_hi, k_lo, k_hi, causal, window):
                    continue
                k_blk = k[:, k_lo:k_hi].float()
                v_blk = v[:, k_lo:k_hi].float()
                s_blk = torch.einsum("bqhgd,bkhd->bqhgk", qg, k_blk) * scale
                mask5 = _block_mask(q_lo, q_hi, k_lo, k_hi, causal, window, dev)[
                    None, :, None, None, :]
                p = torch.where(mask5, torch.exp(s_blk - lse_c[..., None]), 0.0)
                dvv[:, k_lo:k_hi] += torch.einsum("bqhgk,bqhgd->bkhd", p, do_c)
                dp = torch.einsum("bqhgd,bkhd->bqhgk", do_c, v_blk)
                ds = p * (dp - delta_c[..., None]) * scale
                dq[:, q_lo:q_hi] += torch.einsum("bqhgk,bkhd->bqhgd", ds, k_blk)
                dk[:, k_lo:k_hi] += torch.einsum("bqhgk,bqhgd->bkhd", ds, qg)
        return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype),
                None, None, None, None, None)


def blockwise_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                        q_chunk: int = 512, kv_chunk: int = 512, scale: float | None = None):
    """Flash-style online-softmax attention over [q_chunk, kv_chunk] blocks:
    the peak live score block is [qc, kc], never [Sq, Skv].  Any S: where a
    chunk does not divide it, the last chunk is shorter.  ``v`` may have its
    own head dim.  ``scale``: the softmax scale (None: ``1 / sqrt(D)``).

    Where a gradient is wanted it runs as :class:`_BlockwiseAttention`,
    which skips the blocks no query sees and recomputes each query chunk's
    scores in its backward; without one, every block is visited with the
    kv loop marked for rolling (``loops.trips``).  DTensor operands run on
    each rank's shards."""
    if is_dtensor(q) or is_dtensor(k):
        return _on_shards(blockwise_attention, q, k, v, causal=causal, window=window,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, scale=scale)
    scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BlockwiseAttention.apply(q, k, v, causal, window, q_chunk, kv_chunk, scale)
    return _online_softmax(q, k, v, causal, window, q_chunk, kv_chunk, scale,
                           skip=False)[0]


def banded_attention(q, k, v, *, window: int, q_chunk: int = 512):
    """Sliding-window attention with O(S · window) work: each q chunk sees
    only the ``window + q_chunk`` keys that end at its last position.

    Needs ``q_chunk | S``, as the JAX version asserts.  DTensor operands run
    on each rank's shards.
    """
    if is_dtensor(q) or is_dtensor(k):
        return _on_shards(banded_attention, q, k, v, window=window, q_chunk=q_chunk)
    b, s, h, d = q.shape
    if s % q_chunk:
        raise ValueError(f"banded_attention needs the sequence length to be a "
                         f"multiple of q_chunk: S={s}, q_chunk={q_chunk}")
    nq = s // q_chunk
    band = window + q_chunk  # worst-case KV extent one q chunk can see
    kp = zero_pad(k, 1, band)
    vp = zero_pad(v, 1, band)
    outs = []
    for qi in range(nq):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        # Band ends at the chunk's last position; padded coords shift by +band.
        start = qi * q_chunk + q_chunk
        kc = kp[:, start:start + band]
        vc = vp[:, start:start + band]
        # entries with absolute position < 0 are left-padding -> mask them
        valid_from = band - q_chunk * (qi + 1)
        outs.append(full_attention(qc, kc, vc, causal=True, window=window,
                                   q_offset=band - q_chunk,
                                   kv_valid_from=valid_from))
    return torch.cat(outs, dim=1)


def decode_attention(q1, k_cache, v_cache, length, *, window: int | None = None):
    """One-token decode.  q1: [B, 1, H, D]; caches: [B, S_max, Hkv, D];
    ``length``: [B] tensor (or int) of valid cache entries per lane.

    DTensor operands run on each rank's shards.  Where the caches split
    their sequence over a mesh dim (``launch/sharding.cache_shardings``
    puts it on ``model``), each rank scores its own keys and the softmax
    takes its max and sum, and the product its sum, by explicit
    all-reduces over that dim.
    """
    if is_dtensor(q1) or is_dtensor(k_cache):
        return _decode_on_shards(q1, k_cache, v_cache, length, window)
    return _decode_local(q1, k_cache, v_cache, length, window)


def _decode_local(q1, k_cache, v_cache, length, window, kv_offset: int = 0,
                  seq_groups=()):
    """:func:`decode_attention` on plain tensors.  ``kv_offset``: the global
    position of the cache's first row; ``seq_groups``: the ``(mesh, dim)``
    groups over which the sequence is split (none: the whole softmax here)."""
    b, _, h, d = q1.shape
    n_kv = k_cache.shape[2]
    qg = _grouped(q1, n_kv)[:, 0]  # [B, Hkv, G, D]
    scores = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_cache.float()) / math.sqrt(d)
    kpos = torch.arange(k_cache.shape[1], device=q1.device)[None, :]
    if kv_offset:
        kpos = kpos + kv_offset
    length = torch.as_tensor(length, device=q1.device).reshape(-1, 1)
    mask = kpos < length
    if window is not None:
        mask = mask & (kpos >= length - window)
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    if not seq_groups:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype), v_cache)
        return out.reshape(b, 1, h, d)
    import torch.distributed._functional_collectives as funcol

    def over_seq(t, op):
        for g in seq_groups:
            t = funcol.all_reduce(t, op, g)
        return t

    # softmax(x) = exp(x - max) / sum, max and sum over every rank's keys;
    # the product's partial sums add in float32 and round once, as one
    # product over the whole sequence does
    m = over_seq(torch.amax(scores, dim=-1, keepdim=True), "max")
    e = torch.exp(scores - m)
    probs = e / over_seq(torch.sum(e, dim=-1, keepdim=True), "sum")
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype).float(), v_cache.float())
    return over_seq(out, "sum").to(v_cache.dtype).reshape(b, 1, h, d)


def _decode_on_shards(q1, k_cache, v_cache, length, window):
    """:func:`decode_attention` for DTensor operands: rows follow the
    cache's lanes; heads split over ``model`` where the cache keeps its
    sequence whole there (:func:`_layout`)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = next(t for t in (q1, k_cache) if is_dtensor(t)).device_mesh
    q1, k_cache, v_cache = (as_dtensor(t, mesh) for t in (q1, k_cache, v_cache))
    seq = [i for i, p in enumerate(k_cache.placements) if p == Shard(1)]
    pq, pkv = _layout(k_cache, q1.shape[2], k_cache.shape[2], seq)
    k = k_cache.redistribute(mesh, pkv)
    b = q1.shape[0]
    if not torch.is_tensor(length):
        length = torch.full((b,), length, dtype=torch.long)
    rows = [p if p == Shard(0) else Replicate() for p in pq]
    length = as_dtensor(length.to(q1.device).reshape(b), mesh).redistribute(mesh, rows)
    out = _decode_local(q1.redistribute(mesh, pq).to_local(), k.to_local(),
                        v_cache.redistribute(mesh, pkv).to_local(), length.to_local(),
                        window, local_offset(k, 1) if seq else 0,
                        [(mesh, i) for i in seq])
    return wrap_local(out, mesh, pq, tuple(q1.shape))


class PagedTables(NamedTuple):
    """A paged decode step's block tables: ``tables`` ``[B, max_blocks]``
    (each lane's logical blocks to physical pool blocks), ``block_size``,
    ``max_len`` to cut each gathered view to, and ``where``: each lane's
    (physical block, offset) for the step's new token, computed once for
    every layer."""

    tables: torch.Tensor
    block_size: int
    max_len: int
    where: tuple


def paged_tables(paged, lengths) -> PagedTables:
    """``paged`` as given to ``decode_step`` / ``mla_decode``, ``(tables,
    block_size, max_len)``, with the new token's write positions for
    ``lengths``.  Retired lanes have all-null tables and length 0, so their
    writes land in the null block 0.  DTensor tables or lengths are made
    whole first (every rank indexes every lane's blocks)."""
    if isinstance(paged, PagedTables):
        return paged
    tables, bs, max_len = paged
    tables, lengths = (t.full_tensor() if is_dtensor(t) else t for t in (tables, lengths))
    rows = torch.arange(tables.shape[0], device=tables.device)
    return PagedTables(tables, bs, max_len, (tables[rows, lengths // bs], lengths % bs))


def _pool_layout(pool, lead: int):
    """For a DTensor pool ``[num_blocks, block_size, ...]``: the mesh dims
    that split its blocks, and the placements of a per-lane tensor whose
    trailing dims are the pool's from dim 2 on, after ``lead`` leading dims
    (whole along the lanes)."""
    from torch.distributed.tensor import Replicate, Shard

    split, lanes = [], []
    for i, p in enumerate(pool.placements):
        if p == Shard(0):
            split.append(i)
            lanes.append(Replicate())
        elif isinstance(p, Shard) and p.dim >= 2:
            lanes.append(Shard(p.dim - 2 + lead))
        elif isinstance(p, Shard):
            raise ValueError(f"a pool split along its block rows: {pool.placements}")
        else:
            lanes.append(Replicate())
    return split, lanes


def paged_view(pool, paged: PagedTables):
    """One layer's per-lane view ``[B, max_len, ...]`` of a block pool
    through the block tables, laid out as a contiguous cache line is.

    A DTensor pool whose blocks are split over mesh dims (``launch/
    sharding.paged_cache_shardings`` puts them on the data axes) is gathered
    shard by shard: each rank takes the blocks it holds, zeros for the rest,
    and an all-reduce over those dims sums the pieces into every lane's
    whole view on every rank."""
    b = paged.tables.shape[0]
    if not is_dtensor(pool):
        view = pool[paged.tables].reshape((b, -1) + tuple(pool.shape[2:]))
        return view[:, :paged.max_len].contiguous()
    import torch.distributed._functional_collectives as funcol

    mesh = pool.device_mesh
    split, placements = _pool_layout(pool, 2)
    pool_l = pool.to_local()
    idx = paged.tables
    if split:
        idx = idx - local_offset(pool, 0)
        inside = (idx >= 0) & (idx < pool_l.shape[0])
        idx = idx.clamp(0, pool_l.shape[0] - 1)
    view = pool_l[idx]
    if split:
        view = torch.where(inside.reshape(inside.shape + (1,) * (view.dim() - 2)), view, 0)
    view = view.reshape((b, -1) + tuple(pool_l.shape[2:]))[:, :paged.max_len].contiguous()
    for i in split:
        view = funcol.all_reduce(view, "sum", (mesh, i))
    return wrap_local(view, mesh, placements,
                      (b, view.shape[1]) + tuple(pool.shape[2:]))


def paged_write(pool, paged: PagedTables, new) -> None:
    """Write each lane's new token row at its (physical block, offset).

    A DTensor pool whose blocks are split is written shard by shard: every
    rank takes every lane's row and writes those whose block it holds.  A
    lane whose block lies elsewhere rewrites the first such row with the
    same value (or, on a rank that holds none of them, its first row with
    its old value), so no two writes of one position carry two values."""
    if not is_dtensor(pool):
        pool[paged.where] = new.to(pool.dtype)
        return
    mesh = pool.device_mesh
    split, placements = _pool_layout(pool, 1)
    new_l = as_dtensor(new, mesh).redistribute(mesh, placements).to_local().to(pool.dtype)
    pool_l = pool.to_local()
    blk, off = paged.where
    if not split:
        pool_l[blk, off] = new_l
        return
    blk = blk - local_offset(pool, 0)
    inside = (blk >= 0) & (blk < pool_l.shape[0])
    first = torch.argmax(inside.to(torch.int8))
    some = inside.any()
    blk = torch.where(inside, blk, torch.where(some, blk[first], 0))
    off = torch.where(inside, off, torch.where(some, off[first], 0))
    keep = inside.reshape((-1,) + (1,) * (new_l.dim() - 1))
    pool_l[blk, off] = torch.where(keep, new_l,
                                   torch.where(some, new_l[first], pool_l[0, 0]))


def roll_seq(x, shift: int):
    """``torch.roll(x, shift, dims=1)`` as one ``cat`` of two slices (torch
    2.11's DTensor has no rule for ``aten.roll``; the values are the same)."""
    shift %= x.shape[1]
    if not shift:
        return x
    return torch.cat([x[:, -shift:], x[:, :-shift]], dim=1)


def write_prefix(cache, new) -> None:
    """``cache[:, :S] = new`` in place for ``new`` of length S along dim 1
    (a prefill's rows, from position 0).

    A DTensor cache whose dim 1 is split (``cache_shardings`` puts a
    cache's sequence on ``model``) is written shard by shard: ``new`` takes
    the cache's layout with dim 1 whole, and each rank copies the rows that
    fall inside its own slice of the sequence.
    """
    s = new.shape[1]
    if not is_dtensor(cache):
        cache[:, :s] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    whole = [Replicate() if p == Shard(1) else p for p in cache.placements]
    new_l = as_dtensor(new, mesh).redistribute(mesh, whole).to_local()
    cache_l = cache.to_local()
    lo = local_offset(cache, 1)
    n = max(0, min(s - lo, cache_l.shape[1]))
    if n:
        cache_l[:, :n] = new_l[:, lo:lo + n].to(cache_l.dtype)


def write_token(cache, pos, new, rows=None) -> None:
    """``cache[b, pos[b]] = new[b]`` for every lane ``b``, in place.

    ``cache``: ``[B, S, ...]``; ``pos``: ``[B]``; ``new``: ``[B, ...]``;
    ``rows``: ``arange(B)`` on the cache's device, made once by a caller
    that writes several caches.  A DTensor cache (the dry-run's sharded
    decode cells) is written shard by shard, as XLA partitions the JAX
    package's ``.at[].set``: ``pos`` and ``new`` take the cache's batch
    layout, and each shard writes the lanes whose position falls inside its
    slice of S (the others write their own old row back), so no shard leaves
    its place.
    """
    if not is_dtensor(cache):
        if rows is None:
            rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = cache.device_mesh
    pl = cache.placements
    batch_pl = [Shard(0) if p == Shard(0) else Replicate() for p in pl]

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return t.redistribute(mesh, batch_pl).to_local()

    pos_l, new_l = local(pos), local(new)
    cache_l = cache.to_local()
    coord = mesh.get_coordinate()
    s_l = cache_l.shape[1]
    shard = 0
    for i, p in enumerate(pl):
        if p == Shard(1):
            shard = shard * mesh.size(i) + coord[i]
    rel = pos_l.long() - shard * s_l
    inside = (rel >= 0) & (rel < s_l)
    rel = rel.clamp(0, s_l - 1)
    rows = torch.arange(cache_l.shape[0], device=cache_l.device)
    keep = inside.reshape((-1,) + (1,) * (new_l.dim() - 1))
    cache_l[rows, rel] = torch.where(keep, new_l.to(cache_l.dtype), cache_l[rows, rel])
