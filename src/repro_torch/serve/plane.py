"""InferencePlane: one slot pool, the device half of the engine.

A plane owns every device-resident object (the compute-dtype weights, the
slot-pool cache) for one pool; the engine above it only moves token ids and
bookkeeping.  Without a mesh it lives on one device.  With ``mesh`` (a
``MeshSpec`` realised over the process group, or a ``DeviceMesh``) it is
the JAX package's sharded plane (ROADMAP.md queue 1, item 7e), every
rank one device of the (data × model) mesh, all of them running the same
steps on the same host bookkeeping:

- parameters tensor parallel over ``model`` by ``launch/sharding``'s rules,
  with no FSDP (a decode step would re-gather FSDP shards at every token);
  planes handed one placed tree share its shards, as JAX's ``device_put``
  dedupes;
- the cache by ``cache_shardings`` (lanes over the data axes, the sequence
  over ``model``) or ``paged_cache_shardings`` (pool blocks over the data
  axes), each rank allocating its own shards;
- the lane rows (tokens, lengths) over the data axes when ``slots``
  divides their extent, else whole on every rank;
- ``act_hints`` pinning the activations, as the JAX programs' sharding
  constraints; the sampler draws each lane from its whole row.

Every DTensor op of a step runs on each rank's shards, and the ones with no
sharding rule in the card's torch (the attention and WKV einsums over a
split head dim, the ring write, the cache and pool scatters, the paged
gathers) are written in their SPMD form with local ops and explicit
collectives (``models/lm/attention.py``).

- ``decode``: one batched decode step over all ``slots`` lanes, retired
  lanes included (their length is 0; their recurrent state, conv tail and
  ring are replaced whole at the next scatter, as in the JAX package).
- ``prefill_into``: BATCHED prefill: ``[k, plen]`` prompts through one
  forward that fills its own k-batch cache, then one ``scatter_cache``
  writes all k lanes into the pool.

Sampling runs in both via ``sampling.keyed_sample``: per-lane (rid, seed,
temperature, top_k, top_p) rows ride next to the length row, and each lane's
token is drawn with the request-keyed ``fold_in(fold_in(key(seed), rid),
position)``, a pure function of the request.  Prefill draws at ``pos =
plen`` and decode at ``lengths + 1``.

One-pull-per-step invariant: decode bookkeeping (lengths, next tokens,
sampling rows, block tables) is host-resident numpy, uploaded as arguments;
the only blocking device→host sync per decode step (and per prefill group)
is the single ``common.device_get`` of the sampled token row (on every
rank of a mesh, which makes the row whole first).

``PagedInferencePlane`` swaps the contiguous per-slot cache lines for a
shared block pool (``serve.blocks.BlockPool``) with per-lane block tables:
slot memory then scales with the pool you provision (live tokens), not
``max_len x slots``.  Its decode cuts each layer's gathered view to
``max_len``, so the attention sees the contiguous plane's shapes and its
tokens are the contiguous plane's at every block size.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.core.distributed import MeshSpec, as_spec, is_dtensor, shard_local
from repro_torch.device import resolve_device
from repro_torch.models.lm import model as lm
from repro_torch.models.lm.config import LMConfig
from repro_torch.serve import common, sampling
from repro_torch.serve.blocks import BlockPool
from repro_torch.serve.server import ServeConfig
from repro_torch.tree import tree_leaves, tree_map


def _decode_positions(lengths: np.ndarray) -> np.ndarray:
    """Absolute position of the token each decode step SAMPLES: the input
    token sits at index ``lengths``, so the draw lands at ``lengths + 1``."""
    return lengths + np.int32(1)


def realise_mesh(mesh, device: torch.device):
    """``mesh`` as a ``DeviceMesh`` of ``device``'s type: a ``MeshSpec`` is
    realised over the default process group, whose world must equal its
    slots (``launch/mesh.device_mesh`` raises ``ValueError`` otherwise); a
    ``DeviceMesh`` is returned as it is."""
    from repro_torch.launch.mesh import device_mesh

    if isinstance(mesh, MeshSpec):
        return device_mesh(mesh, device.type)
    if mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a plane on {device}")
    return mesh


def _shard(tree, shardings, dm):
    return tree_map(lambda t, sh: shard_local(t, dm, sh.placements(dm)), tree, shardings)


def place_params(params, cfg: LMConfig, dm, device: torch.device):
    """The compute copy of ``params`` laid out for serving on the
    ``DeviceMesh`` ``dm``: ``launch/sharding.lm_param_shardings`` with no
    FSDP, each rank keeping its own shards.  Leaves already placed so are
    kept, so planes handed one placed tree share one copy of the weights."""
    from repro_torch.launch import sharding as shd

    if not any(is_dtensor(t) for t in tree_leaves(params)):
        params = lm.compute_copy(params, cfg, device)
    shardings = shd.lm_param_shardings(params, cfg, as_spec(dm), fsdp=())

    def put(t, sh):
        want = sh.placements(dm)
        if not is_dtensor(t):
            return shard_local(t, dm, want)
        if t.device_mesh != dm or tuple(t.placements) != want:
            raise ValueError(f"a parameter placed {t.placements} on another mesh or "
                             f"layout than the plane's {want}")
        return t

    return tree_map(put, params, shardings)


class InferencePlane:
    """Slot pool + batched prefill/decode on one device, or sharded over a
    (data × model) mesh (``mesh``; see the module docstring)."""

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 mesh=None, device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.serve = serve
        self.device = resolve_device(device)
        b = serve.slots
        #: the ``MeshSpec`` served over (``mesh.shape`` as JAX's), or None
        self.mesh = None
        self.device_mesh = None
        self.hints = self._lane_hints = None
        if mesh is None:
            # a tree already in the compute dtype on this device is shared as is
            self.params = lm.compute_copy(params, cfg, self.device)
        else:
            from repro_torch.launch.mesh import dp_axes, dp_size
            from repro_torch.launch.sharding import NamedSharding, P
            from repro_torch.launch.specs import act_hints

            self.device_mesh = realise_mesh(mesh, self.device)
            self.mesh = as_spec(self.device_mesh)
            self.params = place_params(params, cfg, self.device_mesh, self.device)
            # lane rows over the data axes when the pool divides them, else whole
            dp = dp_axes(self.mesh)
            lanes = P(dp) if b % dp_size(self.mesh) == 0 else P()
            self._lane_placements = NamedSharding(self.mesh, lanes).placements(
                self.device_mesh)
            self._whole = NamedSharding(self.mesh, P()).placements(self.device_mesh)
            self._dp = dp_size(self.mesh)
            self.hints = act_hints(cfg, self.mesh)
            if b % self._dp:
                # lanes the data extent does not divide decode whole: XLA
                # pads an uneven split, DTensor's reshapes refuse one
                self._lane_hints = {
                    k: h if h is None else NamedSharding(h.mesh, P(None, *h.spec[1:]))
                    for k, h in self.hints.items()}
            else:
                self._lane_hints = self.hints

        self.cache = self._init_cache()
        # host-resident decode bookkeeping: uploaded as arguments, never
        # pulled.  The sampling rows mirror the length row, so a lane's draw
        # is a pure function of ITS request.
        self.lengths = np.zeros((b,), np.int32)
        self.tokens = np.zeros((b, 1), np.int32)
        self.rids = np.zeros((b,), np.int32)
        self.seeds = np.zeros((b,), np.uint32)
        self.temps = np.zeros((b,), np.float32)
        self.top_ks = np.full((b,), sampling.TOP_K_OFF, np.int32)
        self.top_ps = np.full((b,), sampling.TOP_P_OFF, np.float32)

    def _init_cache(self):
        return self._placed(lm.init_cache(self.cfg, self.serve.slots, self.serve.max_len,
                                          self.device))

    def _placed(self, cache, mask=None):
        """A cache tree laid out on the mesh by ``cache_shardings`` (with a
        paged ``mask``: ``paged_cache_shardings``); no mesh: as it is."""
        if self.mesh is None:
            return cache
        from repro_torch.launch import sharding as shd

        sh = (shd.cache_shardings(cache, self.cfg, self.mesh) if mask is None else
              shd.paged_cache_shardings(cache, self.cfg, self.mesh, mask))
        return _shard(cache, sh, self.device_mesh)

    def _program(self):
        """The context of a sharded step: plain tensors the model makes
        (position grids, masks) count as replicated."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()

    def _upload(self, row: np.ndarray, *, lanes: bool = True) -> torch.Tensor:
        """A host row of token ids or lengths on the device: on a mesh, split
        as the lane rows are (``lanes``) or whole on every rank."""
        t = common.to_device(row, self.device)
        if self.mesh is None:
            return t
        return shard_local(t, self.device_mesh,
                           self._lane_placements if lanes else self._whole)

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

    def _decode_rows(self):
        return (self.rids, self.seeds, _decode_positions(self.lengths),
                self.temps, self.top_ks, self.top_ps)

    # ------------------------------------------------------------------ lanes
    def free_slots(self) -> list[int]:
        """Lanes with no resident sequence (length 0 = masked/never filled)."""
        return [i for i in range(self.serve.slots) if self.lengths[i] == 0]

    def cache_bytes(self) -> int:
        """Resident device bytes of this plane's cache (pool or lines)."""
        return sum(leaf.nbytes for leaf in tree_leaves(self.cache))

    def _prefill(self, prompts: np.ndarray, rows: tuple):
        """One forward over ``[k, plen]`` prompts into a fresh k-batch cache
        of ``max_len`` lines.  Returns (first tokens on the host, sub cache):
        the group's one device→host pull.

        On a mesh the prompts are whole on every rank and the sub cache is
        laid out by ``cache_shardings``; a group that the data extent does
        not divide is padded with greedy empty prompts up to a multiple of
        it (XLA pads an uneven split; DTensor's reshapes refuse one), and
        the padding lanes are never scattered into the pool."""
        k, plen = prompts.shape
        pad = 0 if self.mesh is None else -k % self._dp
        if pad:
            prompts = np.concatenate([prompts, np.zeros((pad, plen), prompts.dtype)])
            rows = tuple(np.concatenate([np.asarray(r), fill]) for r, fill in zip(
                rows, (np.zeros((pad,), np.int32),) + sampling.sample_rows([], pad)))
        sub = self._placed(lm.init_cache(self.cfg, k + pad, self.serve.max_len,
                                         self.device))
        logits, sub, _ = lm.prefill(self.params, self.cfg,
                                    self._upload(prompts, lanes=False), sub,
                                    shardings=self.hints)
        grids, seeds, temps, tks, tps = rows
        positions = np.full((k + pad,), plen, np.int32)  # prompt occupies 0..plen-1
        toks = common.device_get(sampling.keyed_sample(
            logits, grids, seeds, positions, temps, tks, tps))
        return toks[:k], sub

    def _check_group(self, slots, prompts) -> None:
        if prompts.ndim != 2 or prompts.shape[0] != len(slots):
            raise ValueError(f"prompts must be [len(slots), plen], got "
                             f"{prompts.shape} for {len(slots)} slots")

    def _commit(self, slots, plen: int, toks) -> None:
        for i, slot in enumerate(slots):
            self.lengths[slot] = plen
            self.tokens[slot, 0] = toks[i]

    def prefill_into(self, slots: list[int], prompts: np.ndarray,
                     budgets: list[int] | None = None,
                     rids: list[int] | None = None,
                     samples=None) -> np.ndarray:
        """Batched prefill of ``[k, plen]`` prompts into ``slots`` (len k).

        ``budgets`` (per-request remaining token budgets) is accepted for
        interface parity with the paged plane, which sizes each lane's block
        allocation from it; contiguous lanes are pre-sized to ``max_len``.
        ``rids``/``samples`` carry each request's identity and sampling
        contract into the keyed sampler (defaults: rid 0, greedy).  Returns
        the k first tokens (host).  One device->host pull for the group.
        """
        self._check_group(slots, prompts)
        rows = self._set_sample_rows(slots, rids, samples)
        with self._program():
            toks, sub = self._prefill(prompts, rows)
            lm.scatter_cache(self.cache, sub, slots)
        self._commit(slots, prompts.shape[1], toks)
        return toks

    def decode(self) -> np.ndarray:
        """One batched decode step over the pool.  Returns the sampled token
        row (host, [slots]): the step's single device→host pull."""
        with self._program():
            logits, self.cache = lm.decode_step(
                self.params, self.cfg, self._upload(self.tokens), self.cache,
                self._upload(self.lengths), shardings=self._lane_hints)
            toks = sampling.keyed_sample(logits, *self._decode_rows())
        return common.device_get(toks)

    def advance(self, slot: int, tok: int) -> None:
        """Commit a decode step's token on a live lane."""
        self.lengths[slot] += 1
        self.tokens[slot, 0] = tok

    def release(self, slot: int) -> None:
        """Retire a lane: mask its token/length so later decode steps never
        read its stale state (the cache slice is replaced at next prefill).
        Sampling rows reset to greedy: a dead lane's draw is a pure argmax
        and cannot consume or perturb any request's keyed stream."""
        self.lengths[slot] = 0
        self.tokens[slot, 0] = 0
        self.rids[slot] = 0
        self.seeds[slot] = 0
        self.temps[slot] = 0.0
        self.top_ks[slot] = sampling.TOP_K_OFF
        self.top_ps[slot] = sampling.TOP_P_OFF


class PagedInferencePlane(InferencePlane):
    """Slot pool backed by a shared paged KV-cache (block pool + tables).

    The pool holds ``1 + pool_blocks`` physical blocks per layer (block 0 is
    the null block retired lanes write into), padded up to a multiple of
    the mesh's data extent so that the blocks split evenly (JAX's
    ``n_dev``; one device: no padding).  The host keeps the block
    tables ``[slots, max_blocks]`` and uploads them as a decode argument:
    tiny, and the one-pull-per-step invariant holds.  Block allocation is
    up-front at prefill, ``blocks_for(min(prompt + budget, max_len))`` per
    request, so decode never allocates and admission failure is a clean
    ``Backpressure`` from ``BlockPool.alloc``.
    """

    def __init__(self, params, cfg: LMConfig, serve: ServeConfig, *,
                 mesh=None, device: str | torch.device = "cuda"):
        if serve.block_size is None or serve.block_size < 1:
            raise ValueError(f"paged plane needs block_size >= 1, "
                             f"got {serve.block_size}")
        self.block_size = serve.block_size
        #: table width: logical blocks per lane at max_len
        self.max_blocks = -(-serve.max_len // serve.block_size)
        self.pool = BlockPool(serve.pool_capacity(), serve.block_size)
        self._mask = lm.paged_cache_mask(cfg)
        super().__init__(params, cfg, serve, mesh=mesh, device=device)
        #: host block tables; the row of a retired lane is all-null
        self.tables = np.zeros((serve.slots, self.max_blocks), np.int32)
        self._blocks: list[list[int]] = [[] for _ in range(serve.slots)]

    def _init_cache(self):
        from repro_torch.launch.mesh import dp_size

        dp = 1 if self.mesh is None else dp_size(self.mesh)
        #: device pool blocks: the null block and the usable ones, padded
        self.n_dev = -(-(1 + self.pool.num_blocks) // dp) * dp
        return self._placed(
            lm.init_paged_cache(self.cfg, self.serve.slots, self.serve.max_len,
                                num_blocks=self.n_dev, block_size=self.block_size,
                                device=self.device), self._mask)

    # ------------------------------------------------------------- accounting
    def block_cost(self, prompt_len: int, budget: int) -> int:
        """Blocks a request occupies for its lifetime (allocated up front)."""
        return self.pool.blocks_for(min(prompt_len + budget, self.serve.max_len))

    def free_blocks(self) -> int:
        return self.pool.available

    # ------------------------------------------------------------------ lanes
    def prefill_into(self, slots: list[int], prompts: np.ndarray,
                     budgets: list[int] | None = None,
                     rids: list[int] | None = None,
                     samples=None) -> np.ndarray:
        """Paged batched prefill: allocate each lane's lifetime blocks, land
        the prompt blocks through the tables, record first tokens.

        Raises ``Backpressure`` (after rolling back the group's partial
        allocations) if the pool cannot cover the group: the Router's block
        accounting makes this unreachable in the engine path, but direct
        callers get the clean failure instead of corrupted tables.
        """
        self._check_group(slots, prompts)
        k, plen = prompts.shape
        if budgets is None:
            budgets = [self.serve.max_new_tokens] * k
        got: list[list[int]] = []
        try:
            for budget in budgets:
                got.append(self.pool.alloc(self.block_cost(plen, budget)))
        except Exception:
            for blocks in got:
                self.pool.free(blocks)
            raise
        nbp = self.pool.blocks_for(plen)  # blocks the prompt itself covers
        for slot, blocks in zip(slots, got):
            self._blocks[slot] = blocks
            self.tables[slot, :] = 0
            self.tables[slot, :len(blocks)] = blocks
        phys = np.stack([self.tables[slot, :nbp] for slot in slots])

        rows = self._set_sample_rows(slots, rids, samples)
        with self._program():
            toks, sub = self._prefill(prompts, rows)
            lm.scatter_cache_paged(self.cache, sub, slots, phys,
                                   block_size=self.block_size, mask=self._mask)
        self._commit(slots, plen, toks)
        return toks

    def decode(self) -> np.ndarray:
        """One batched decode step through the block tables (whole on every
        rank of a mesh).  Same single-pull contract as the contiguous plane."""
        paged = (common.to_device(self.tables, self.device), self.block_size,
                 self.serve.max_len)
        with self._program():
            logits, self.cache = lm.decode_step(
                self.params, self.cfg, self._upload(self.tokens), self.cache,
                self._upload(self.lengths), paged=paged,
                shardings=self._lane_hints)
            toks = sampling.keyed_sample(logits, *self._decode_rows())
        return common.device_get(toks)

    def release(self, slot: int) -> None:
        """Retire a lane: free its blocks back to the pool and null its
        table row, so the lane's masked decode writes land in block 0."""
        super().release(slot)
        if self._blocks[slot]:
            self.pool.free(self._blocks[slot])
            self._blocks[slot] = []
        self.tables[slot, :] = 0
