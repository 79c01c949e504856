"""Port parity for paged KV caches: ``init_paged_cache``,
``paged_cache_mask``, ``scatter_cache_paged``, the paged decode (full
attention and MLA) and ``PagedInferencePlane`` behind ``ServeEngine``.

- The pool layout and the paged mask equal the JAX package's, leaf by leaf
  (qwen1.5-4b's full-attention k/v, deepseek-v2-lite-16b's MLA latents, and
  recurrentgemma-2b, whose rec and swa leaves stay per lane).
- ``scatter_cache_paged`` moves the same values into the same pool rows as
  the JAX function, bit for bit, at block sizes that divide the line and
  that do not.
- Paged decode (prefill, scatter, 4 steps through the tables) gives the JAX
  package's paged logits within atol 1e-5 plus rtol 1e-4 (float32), and the
  port's paged logits EQUAL its contiguous logits at every block size: the
  port cuts each gathered view to ``max_len``, so the attention sees the
  contiguous cache's shapes.
- ``ServeEngine`` with paged planes (qwen1.5-4b smoke, the reference's
  ``lm_setup``) generates exactly the JAX ``Server``'s tokens at block sizes
  4, 5 and 16 with 1 and 2 planes (the cases of tests/test_serve.py), with a
  pool sized to live tokens, under block backpressure, one device pull per
  step, and never-fitting requests rejected at submit; the router's block
  budget pops the JAX router's groups.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import bridge, close, jax_paths, t_
from repro.models.lm import model as jm
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.models.lm import mla as tmla
from repro_torch.models.lm import model as tm
from repro_torch.serve import (InferencePlane, PagedInferencePlane, ServeConfig,
                               ServeEngine, count_transfers)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

ARCHS = ("qwen1.5-4b", "deepseek-v2-lite-16b", "recurrentgemma-2b")


@pytest.fixture(scope="module")
def lm_setup():
    """qwen1.5-4b's smoke config at the reference's seed 1, bridged."""
    jcfg, tcfg, jparams, tparams = bridge("qwen1.5-4b", seed=1)
    return jcfg, tcfg, jparams, tparams


def _prompts(n, rng, lo=2, hi=10):
    return [rng.integers(0, 120, size=int(rng.integers(lo, hi))) for _ in range(n)]


def _jax_reference(jparams, jcfg, sc: dict, prompts, **submit):
    srv = JaxServer(jparams, jcfg, JaxServeConfig(**sc))
    for i, p in enumerate(prompts):
        srv.submit(p, **{k: v(i) for k, v in submit.items()})
    return srv.run()


# ------------------------------------------------------------------- layout
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_layout_and_mask_match_jax(arch):
    jcfg, tcfg, _, _ = bridge(arch)
    jc = jm.init_paged_cache(jcfg, 3, 20, num_blocks=7, block_size=4)
    tc = tm.init_paged_cache(tcfg, 3, 20, num_blocks=7, block_size=4, device="cpu")
    assert tree_paths(tc) == jax_paths(jc)
    for ours, theirs in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        assert tuple(ours.shape) == theirs.shape
        assert str(ours.dtype).endswith(str(theirs.dtype))
        assert not ours.any()
    assert tree_leaves(tm.paged_cache_mask(tcfg)) == \
        [bool(m) for m in jax.tree.leaves(jm.paged_cache_mask(jcfg))]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bs", [4, 5])
def test_scatter_cache_paged_matches_jax(arch, bs):
    """Random sub-cache lines of 14 positions into a pool, prompt blocks
    only (the 5-token prompt's nb blocks): every pool leaf equal."""
    jcfg, tcfg, _, _ = bridge(arch)
    max_len, k, plen = 14, 2, 5
    nb = -(-plen // bs)
    rng = np.random.default_rng(bs)
    sub = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                       jm.init_cache(jcfg, k, max_len))
    slots = np.array([2, 0], np.int32)
    phys = np.array([[3, 1, 6][:nb], [5, 2, 4][:nb]], np.int32)
    jc = jm.scatter_cache_paged(jm.init_paged_cache(jcfg, 3, max_len, num_blocks=7,
                                                    block_size=bs),
                                jax.tree.map(jnp.asarray, sub), slots, phys,
                                block_size=bs, mask=jm.paged_cache_mask(jcfg))
    tc = tm.init_paged_cache(tcfg, 3, max_len, num_blocks=7, block_size=bs, device="cpu")
    tsub = tree_map(lambda a: torch.as_tensor(a),
                    jax.tree.map(np.asarray, sub, is_leaf=lambda x: isinstance(x, np.ndarray)))
    tm.scatter_cache_paged(tc, tsub, slots, phys, block_size=bs,
                           mask=tm.paged_cache_mask(tcfg))
    for path, ours, theirs in zip(tree_paths(tc), tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs), err_msg=path)


# ------------------------------------------------------------------- decode
def _paged_decode_run(mod, cfg, params, toks, prompt, bs, *, paged, max_len, torch_side):
    """Prefill 2 lanes into a fresh cache, land it (contiguous or paged at
    block ``bs``), then decode the rest of ``toks`` teacher-forced.
    Returns the list of per-step logits and the final cache."""
    k = toks.shape[0]
    nblk = -(-max_len // bs)
    tables = np.array([[1 + i * nblk + j for j in range(nblk)] for i in range(k)],
                      np.int32)
    dev = {"device": "cpu"} if torch_side else {}
    as_tok = (lambda a: t_(a, torch.long)) if torch_side else jnp.asarray
    sub = mod.init_cache(cfg, k, max_len, **dev)
    logits, sub, lengths = mod.prefill(params, cfg, as_tok(toks[:, :prompt]), sub)
    if paged:
        pool = mod.init_paged_cache(cfg, k, max_len, num_blocks=1 + k * nblk,
                                    block_size=bs, **dev)
        phys = tables[:, :-(-prompt // bs)]
        cache = mod.scatter_cache_paged(pool, sub, np.arange(k, dtype=np.int32), phys,
                                        block_size=bs, mask=mod.paged_cache_mask(cfg))
        tab = t_(tables, torch.long) if torch_side else jnp.asarray(tables)
        extra = {"paged": (tab, bs, max_len) if torch_side else (tab, bs)}
    else:
        cache, extra = sub, {}
    out = [logits]
    for i in range(prompt, toks.shape[1]):
        logits, cache = mod.decode_step(params, cfg, as_tok(toks[:, i:i + 1]), cache,
                                        lengths, **extra)
        lengths = lengths + 1
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("arch,bs", [(a, b) for a in ARCHS for b in (4, 5)]
                         + [("qwen1.5-4b", 16)])
def test_paged_decode_matches_jax_and_equals_contiguous(arch, bs):
    """max_len 14: block 4 and 5 leave a partial tail block (16 > 14 and
    15 > 14), block 16 one block longer than the line."""
    jcfg, tcfg, jparams, tparams = bridge(arch)
    prompt, steps, max_len = 6, 4, 14
    toks = np.random.default_rng(12).integers(0, tcfg.vocab, (2, prompt + steps)) \
        .astype(np.int32)
    kw = dict(prompt=prompt, bs=bs, max_len=max_len)
    theirs, _ = _paged_decode_run(jm, jcfg, jparams, toks, paged=True, torch_side=False, **kw)
    with torch.no_grad():
        ours, pool = _paged_decode_run(tm, tcfg, tparams, toks, paged=True,
                                       torch_side=True, **kw)
        lines, _ = _paged_decode_run(tm, tcfg, tparams, toks, paged=False,
                                     torch_side=True, **kw)
    for i, (o, t, c) in enumerate(zip(ours, theirs, lines)):
        close(o, t, err_msg=f"step {i}")
        assert torch.equal(o, c), f"paged step {i} differs from the contiguous step"
    mask = tm.paged_cache_mask(tcfg)
    assert any(tree_leaves(mask)) == (arch != "recurrentgemma-2b")


def test_paged_mla_decode_equals_contiguous_at_full_layer():
    """One MLA layer's paged decode against its contiguous decode on the same
    latents (block 3 over a 10-position line: a partial tail block)."""
    _, tcfg, _, tparams = bridge("deepseek-v2-lite-16b")
    m = tcfg.mla
    p = tree_map(lambda t: t[0], tparams["stages"][0]["sub0"]["attn"])
    g = torch.Generator().manual_seed(0)
    b, s, bs = 3, 10, 3
    nblk = -(-s // bs)
    ckv = torch.randn(b, s, m.kv_lora_rank, generator=g)
    kpe = torch.randn(b, s, m.qk_rope_head_dim, generator=g)
    lengths = torch.tensor([4, 9, 0])
    tables = torch.tensor([[1 + i * nblk + j for j in range(nblk)] for i in range(b)])
    tables[2] = 0  # a retired lane: all-null table, writes land in block 0
    ckv_pool = torch.zeros(1 + b * nblk, bs, m.kv_lora_rank)
    kpe_pool = torch.zeros(1 + b * nblk, bs, m.qk_rope_head_dim)
    pad = nblk * bs - s
    ckv_pool[tables[:2]] = torch.nn.functional.pad(ckv[:2], (0, 0, 0, pad)).reshape(
        2, nblk, bs, -1)
    kpe_pool[tables[:2]] = torch.nn.functional.pad(kpe[:2], (0, 0, 0, pad)).reshape(
        2, nblk, bs, -1)
    x = torch.randn(b, 1, tcfg.d_model, generator=g)
    with torch.no_grad():
        y, c2, k2 = tmla.mla_decode(p, tcfg, x, ckv.clone(), kpe.clone(), lengths)
        yp, cp, kp = tmla.mla_decode(p, tcfg, x, ckv_pool, kpe_pool, lengths,
                                     paged=(tables, bs, s))
    assert torch.equal(yp[:2], y[:2])
    for lane in range(2):
        n = int(lengths[lane]) + 1
        view = cp[tables[lane]].reshape(-1, m.kv_lora_rank)[:n]
        assert torch.equal(view, c2[lane, :n])
        assert torch.equal(kp[tables[lane]].reshape(-1, m.qk_rope_head_dim)[:n],
                           k2[lane, :n])


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("block_size", [4, 5, 16])
@pytest.mark.parametrize("planes", [1, 2])
def test_paged_engine_equals_the_jax_server(lm_setup, block_size, planes):
    jcfg, tcfg, jparams, tparams = lm_setup
    sc = dict(slots=2, max_len=48, max_new_tokens=5, eos_id=7)
    prompts = _prompts(7, np.random.default_rng(3))
    ref = _jax_reference(jparams, jcfg, sc, prompts)
    eng = ServeEngine(tparams, tcfg, ServeConfig(**sc, block_size=block_size),
                      planes=planes, device="cpu")
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    for i, rid in enumerate(rids):
        assert got[rid] == ref[i], f"request {i} diverged (bs={block_size})"
    assert all(isinstance(p, PagedInferencePlane) for p in eng.planes)
    assert all(p.pool.available == p.pool.num_blocks for p in eng.planes)


def test_paged_small_pool_equal_and_smaller(lm_setup):
    """A pool sized to LIVE tokens serves the same workload with the JAX
    server's tokens and a smaller resident cache; ``cache_bytes`` equals the
    JAX planes' for both flavours."""
    from repro.serve import InferencePlane as JaxInferencePlane
    from repro.serve import PagedInferencePlane as JaxPagedInferencePlane

    jcfg, tcfg, jparams, tparams = lm_setup
    base = dict(slots=4, max_len=48, max_new_tokens=6)
    sc = ServeConfig(**base, block_size=4, pool_blocks=16)  # 16*4=64 << 4*48
    prompts = _prompts(8, np.random.default_rng(11))
    ref = _jax_reference(jparams, jcfg, base, prompts)
    eng = ServeEngine(tparams, tcfg, sc, device="cpu")
    rids = [eng.submit(p) for p in prompts]
    got = eng.run()
    assert [got[r] for r in rids] == [ref[i] for i in range(len(prompts))]
    paged = eng.planes[0].cache_bytes()
    contiguous = InferencePlane(tparams, tcfg, ServeConfig(**base),
                                device="cpu").cache_bytes()
    assert paged < contiguous
    assert paged == JaxPagedInferencePlane(jparams, jcfg, JaxServeConfig(
        **base, block_size=4, pool_blocks=16)).cache_bytes()
    assert contiguous == JaxInferencePlane(jparams, jcfg,
                                           JaxServeConfig(**base)).cache_bytes()


def test_paged_never_fits_rejected_at_submit(lm_setup):
    _, tcfg, _, tparams = lm_setup
    sc = ServeConfig(slots=2, max_len=48, max_new_tokens=20, block_size=4, pool_blocks=3)
    eng = ServeEngine(tparams, tcfg, sc, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        eng.submit(np.arange(1, 9, dtype=np.int32))  # needs ceil(28/4)=7 > 3
    assert sc.pool_capacity() == 3
    assert ServeConfig(slots=2, max_len=48, block_size=5).pool_capacity() == 20
    assert ServeConfig(slots=2, max_len=48).pool_capacity() == 0


def test_paged_pool_backpressure_defers_not_drops(lm_setup):
    """Room for about one request at a time: the router's block budget
    defers admission (head of line WAITS) and every request completes with
    the JAX server's tokens; occupancy never exceeds the one lane a pool of
    4 blocks can feed at a time."""
    jcfg, tcfg, jparams, tparams = lm_setup
    base = dict(slots=4, max_len=48, max_new_tokens=6)
    sc = ServeConfig(**base, block_size=4, pool_blocks=4)
    prompts = _prompts(5, np.random.default_rng(7), lo=2, hi=8)  # <= 4 blocks each
    ref = _jax_reference(jparams, jcfg, base, prompts)
    eng = ServeEngine(tparams, tcfg, sc, device="cpu")
    rids = [eng.submit(p) for p in prompts]
    seen = []
    while eng.step():
        seen.append(eng.occupancy())
    got = eng.router.results()
    assert [got[r] for r in rids] == [ref[i] for i in range(len(prompts))]
    assert eng.planes[0].pool.available == 4  # all blocks returned
    assert max(seen) == 0.25 and eng.occupancy() == 0.0


def test_paged_one_pull_per_decode_step(lm_setup):
    _, tcfg, _, tparams = lm_setup
    sc = ServeConfig(slots=4, max_len=48, max_new_tokens=8, block_size=8)
    eng = ServeEngine(tparams, tcfg, sc, device="cpu")
    for _ in range(4):
        eng.submit(np.array([3, 1, 4, 1, 5], np.int32))
    with count_transfers() as c:
        eng.step()  # 1 batched prefill + 1 decode
    assert c["pulls"] == 2
    assert eng.occupancy() == 1.0
    with count_transfers() as c:
        eng.step()
    assert c["pulls"] == 1


def test_paged_prefill_rolls_back_on_exhaustion(lm_setup):
    """A direct ``prefill_into`` the pool cannot cover raises
    ``Backpressure`` with the group's partial allocation returned."""
    from repro_torch.serve import Backpressure

    _, tcfg, _, tparams = lm_setup
    plane = PagedInferencePlane(tparams, tcfg, ServeConfig(
        slots=3, max_len=48, max_new_tokens=6, block_size=4, pool_blocks=5),
        device="cpu")
    with pytest.raises(Backpressure):
        plane.prefill_into([0, 1], np.ones((2, 5), np.int32), budgets=[6, 6])
    assert plane.free_blocks() == 5 and not plane.tables.any()
    assert plane.block_cost(5, 6) == 3 and plane.block_cost(40, 20) == 12


def test_router_block_budget_caps_group_as_jax():
    """``pop_group`` with a block budget: the group's summed cost must fit,
    and a leader that does not fit yields an EMPTY group and stays queued;
    the JAX router pops the same groups.  Passing one of the pair alone
    raises."""
    from repro.serve import Router as JaxRouter
    from repro_torch.serve import Router

    routers = (Router(ServeConfig(slots=8, max_len=64, max_new_tokens=4), queue_limit=None),
               JaxRouter(JaxServeConfig(slots=8, max_len=64, max_new_tokens=4),
                         queue_limit=None))
    sizes = []
    for r in routers:
        for _ in range(3):
            r.submit(np.arange(1, 6, dtype=np.int32))  # plen 5, 3 blocks each
        got = [len(r.pop_group(8, token_budget=64, block_budget=b, block_cost=lambda q: 3))
               for b in (7, 2, 3)]
        sizes.append((got, len(r.queue)))
        with pytest.raises(ValueError, match="together"):
            r.pop_group(8, token_budget=64, block_budget=3)
    assert sizes[0] == sizes[1] == ([2, 0, 1], 0)
