"""Port parity for request-keyed sampling (``serve/threefry.py``,
``serve/sampling.py``).

- ``request_key`` and the random bits and uniforms it draws are BIT-EQUAL to
  ``jax.random`` (``fold_in(fold_in(PRNGKey(seed), rid), pos)``,
  ``jax.random.bits``, ``jax.random.uniform(minval=tiny)``) over many
  ``(seed, rid, pos)``, seeds next to 2**32 included.
- ``keyed_sample``'s tokens equal the JAX ``keyed_sample``'s on the same
  float32 or bf16 logits at every draw of the fixed seeds, except that a
  draw whose two largest perturbed values (``filtered / t + gumbel``, the
  port's) lie within 1e-4 may differ: the gumbel noise goes through
  torch's and XLA's float32 ``log``, which differ by some ulps.  Such draws
  are counted and printed; none of the fixed seeds here has one.
- The top-k and top-p filters equal JAX's on the same rows, float32 and
  bf16 (where top-p's mass is summed in bf16 in XLA's blocked association,
  ``_cumsum_blocked``, bit-equal to ``jnp.cumsum``); temperature-0 lanes
  are the argmax of the raw logits whatever their filters.
- The invariances of tests/test_sampling_property.py hold in the port (slot
  permutation, co-batching), and end to end: the port's ``Server`` equals
  the JAX ``Server`` at temperature > 0 (and with top-k / top-p), in
  float32 and in bf16, and the port's engines (1 and 2 planes, paged and
  contiguous) equal the port's ``Server`` bit for bit (qwen1.5-4b smoke,
  the reference's ``lm_setup``), with one device pull a decode step, as
  greedy decoding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lm_parity import bridge
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro.serve import keyed_sample as jax_keyed_sample
from repro.serve import sampling as jsampling
from repro_torch.serve import (SampleParams, ServeConfig, ServeEngine, Server,
                               keyed_sample, threefry)
from repro_torch.serve import sampling
from repro_torch.serve.sampling import TOP_K_OFF, TOP_P_OFF

NEAR_TIE = 1e-4  # perturbed-value gap under which a draw may differ from JAX's
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (seed, rid, pos): small, large and next to the uint32 / int32 edges
KEYS = [(0, 0, 0), (1, 0, 1), (12345, 7, 300), (2**31 - 1, 2**31 - 1, 2**31 - 1),
        (2**31, 5, 9), (2**32 - 1, 0, 0), (2**32 - 1, 1023, 4095), (2**32 - 2, 3, 1),
        (4_000_000_000, 123_456, 777)]


@pytest.fixture(scope="module")
def lm_setup():
    jcfg, tcfg, jparams, tparams = bridge("qwen1.5-4b", seed=1)
    return jcfg, tcfg, jparams, tparams


def _jax_key(seed, rid, pos):
    return jsampling.request_key(seed, jnp.int32(rid), jnp.int32(pos))


def _key_data(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


# ------------------------------------------------------------------ threefry
def test_request_keys_bit_equal_jax():
    seeds, rids, poss = (np.array(c, np.int64) for c in zip(*KEYS))
    ours = sampling.request_key(torch.as_tensor(seeds), torch.as_tensor(rids),
                                torch.as_tensor(poss))
    for i, (seed, rid, pos) in enumerate(KEYS):
        want = _key_data(_jax_key(seed, rid, pos))
        assert [int(ours[0][i]), int(ours[1][i])] == want.tolist(), (seed, rid, pos)


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), rid=st.integers(0, 2**31 - 1),
       pos=st.integers(0, 2**20))
def test_request_key_bits_and_uniforms_bit_equal_jax(seed, rid, pos):
    key = _jax_key(seed, rid, pos)
    ours = sampling.request_key(torch.tensor([seed]), torch.tensor([rid]),
                                torch.tensor([pos]))
    assert [int(ours[0][0]), int(ours[1][0])] == _key_data(key).tolist()
    bits = threefry.random_bits(ours, 1001)[0].numpy()
    np.testing.assert_array_equal(bits, np.asarray(jax.random.bits(key, (1001,)))
                                  .astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    u = threefry.uniform(ours, 1001)[0].numpy()
    want = np.asarray(jax.random.uniform(key, (1001,), jnp.float32, minval=tiny,
                                         maxval=1.0))
    np.testing.assert_array_equal(u.view(np.int32), want.view(np.int32))


def test_prng_key_and_fold_in_bit_equal_jax():
    for seed in (0, 1, 2**32 - 1, 3_141_592_653):
        base = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
        ours = threefry.prng_key(torch.tensor(seed))
        assert [int(ours[0]), int(ours[1])] == _key_data(base).tolist()
        for d in (0, 1, 2**31 - 1, 2**32 - 1):
            want = _key_data(jax.random.fold_in(base, jnp.uint32(d)))
            got = threefry.fold_in(ours, torch.tensor(d))
            assert [int(got[0]), int(got[1])] == want.tolist()


# ------------------------------------------------------------------- filters
def _rows(rng, n, vocab=37):
    """A random batch of lanes: logits + per-lane sampling rows (filters on
    for roughly half the lanes)."""
    logits = rng.standard_normal((n, vocab)).astype(np.float32)
    rids = rng.integers(0, 1000, n).astype(np.int32)
    seeds = rng.integers(0, 2**32, n, dtype=np.uint32)
    positions = rng.integers(1, 64, n).astype(np.int32)
    temps = rng.uniform(0.2, 2.0, n).astype(np.float32)
    tks = np.where(rng.random(n) < 0.5, rng.integers(1, vocab, n),
                   TOP_K_OFF).astype(np.int32)
    tps = np.where(rng.random(n) < 0.5, rng.uniform(0.3, 1.0, n),
                   TOP_P_OFF).astype(np.float32)
    return logits, rids, seeds, positions, temps, tks, tps


def _check_filters(seed, dtype, vocab=50):
    rng = np.random.default_rng(seed)
    logits, _, _, _, _, tks, tps = _rows(rng, 8, vocab=vocab)
    logits[0, :5] = logits[0, 5]  # ties at the k-th value are kept
    tks[0] = 3
    tks[1] = vocab + 30  # past the vocabulary: keeps everything
    ours_k = sampling._filter_top_k(torch.as_tensor(logits).to(TORCH_DTYPE[dtype]),
                                    torch.as_tensor(tks))
    want_k = jax.vmap(jsampling._filter_top_k)(jnp.asarray(logits, dtype), jnp.asarray(tks))
    np.testing.assert_array_equal(ours_k.float().numpy(), np.asarray(want_k, np.float32))
    ours_p = sampling._filter_top_p(ours_k, torch.as_tensor(tps))
    want_p = jax.vmap(jsampling._filter_top_p)(want_k, jnp.asarray(tps))
    np.testing.assert_array_equal(np.isinf(ours_p.float().numpy()),
                                  np.isinf(np.asarray(want_p, np.float32)))


@pytest.mark.parametrize("seed", range(4))
def test_filters_equal_jax(seed):
    _check_filters(seed, "float32")


@pytest.mark.parametrize("seed,vocab", [(0, 50), (1, 50), (2, 1000), (3, 151_936)])
def test_filters_equal_jax_in_bf16(seed, vocab):
    """bf16 logits: the top-p mass is summed in bf16 as the JAX package sums
    it, and a long tail's mass stops growing where JAX's does, so the cut
    is JAX's at every row."""
    _check_filters(seed, "bfloat16", vocab)


def test_cumsum_blocked_is_xla_cumsum():
    rng = np.random.default_rng(5)
    for n in (1, 16, 17, 37, 256, 1000, 4097):
        x = np.abs(rng.standard_normal((3, n))).astype(np.float32) / n
        for dtype in ("float32", "bfloat16"):
            got = sampling._cumsum_blocked(torch.as_tensor(x).to(TORCH_DTYPE[dtype]))
            want = jnp.cumsum(jnp.asarray(x, dtype), axis=-1)
            np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# ------------------------------------------------------------- keyed_sample
def _check_keyed_sample(vocab, dtype):
    rng = np.random.default_rng(vocab)
    draws = near = 0
    for _ in range(12 if vocab < 1000 else 2):
        rows = _rows(rng, 8, vocab)
        rows[0][:, :] *= 3.0
        want = np.asarray(jax_keyed_sample(jnp.asarray(rows[0], dtype),
                                           *(jnp.asarray(r) for r in rows[1:])))
        logits = torch.as_tensor(rows[0]).to(TORCH_DTYPE[dtype])
        got = keyed_sample(logits, *rows[1:]).numpy()
        pert = sampling.perturbed(logits, *rows[1:]).numpy()
        top2 = np.sort(pert, axis=-1)[:, -2:]
        tie = (top2[:, 1] - top2[:, 0] < NEAR_TIE) & (rows[4] > 0)
        near += int(tie.sum())
        draws += len(got)
        np.testing.assert_array_equal(got[~tie], want[~tie])
    print(f"keyed_sample vocab {vocab} {dtype}: {draws} draws, {near} within "
          f"{NEAR_TIE} of a tie")
    assert near == 0


@pytest.mark.parametrize("vocab", [37, 151_936])
def test_keyed_sample_equals_jax_at_every_draw(vocab):
    """Every draw of the fixed seeds, at the smoke vocabulary and at
    qwen1.5-4b's: tokens equal JAX's, near-ties counted and printed."""
    _check_keyed_sample(vocab, "float32")


@pytest.mark.parametrize("vocab", [37, 151_936])
def test_keyed_sample_equals_jax_at_every_draw_in_bf16(vocab):
    """The same on bf16 logits, the served archs' own dtype: the filters run
    in bf16 as JAX's do, the quotient by the float32 temperature and the
    gumbel noise are float32 in both packages."""
    _check_keyed_sample(vocab, "bfloat16")


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(2, 8))
def test_keyed_sample_slot_permutation_invariant(seed, n):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, n)
    base = keyed_sample(torch.as_tensor(rows[0]), *rows[1:]).numpy()
    perm = rng.permutation(n)
    shuffled = keyed_sample(torch.as_tensor(rows[0][perm]),
                            *(r[perm] for r in rows[1:])).numpy()
    np.testing.assert_array_equal(shuffled, base[perm])


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(2, 8))
def test_keyed_sample_co_batch_invariant(seed, n):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, n)
    batched = keyed_sample(torch.as_tensor(rows[0]), *rows[1:]).numpy()
    for i in range(n):
        alone = keyed_sample(torch.as_tensor(rows[0][i:i + 1]),
                             *(r[i:i + 1] for r in rows[1:])).numpy()
        assert alone[0] == batched[i], f"lane {i} perturbed by co-batching"


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**16), n=st.integers(1, 8))
def test_keyed_sample_greedy_identity(seed, n):
    rng = np.random.default_rng(seed)
    logits, rids, seeds, positions, _temps, tks, tps = _rows(rng, n)
    temps = np.zeros((n,), np.float32)
    got = keyed_sample(torch.as_tensor(logits), rids, seeds, positions, temps, tks, tps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits, axis=-1))


def test_sample_params_validate_like_jax():
    SampleParams(seed=2**32 - 1, temperature=0.7, top_k=50, top_p=0.9).validate()
    ServeConfig(temperature=0.7, top_k=5, top_p=0.5)
    for bad in (dict(temperature=-1.0), dict(temperature=float("nan")),
                dict(seed=2**32), dict(seed=-1), dict(top_k=-1), dict(top_p=0.0),
                dict(top_p=1.5)):
        with pytest.raises(ValueError):
            SampleParams(**bad).validate()
        with pytest.raises(ValueError):
            jsampling.SampleParams(**bad).validate()


# ---------------------------------------------------------------- end to end
def _check_servers_at_temperature(setup, example_seed):
    jcfg, tcfg, jparams, tparams = setup
    sc = dict(slots=2, max_len=48, max_new_tokens=4)
    rng = np.random.default_rng(example_seed)
    prompts = [rng.integers(0, 120, size=int(rng.integers(2, 8))) for _ in range(5)]
    temps = rng.uniform(0.3, 1.5, size=5)
    seeds = rng.integers(0, 2**16, size=5)

    def kw(i):
        filt = dict(top_k=20, top_p=0.9) if i % 2 else {}
        return dict(temperature=float(temps[i]), seed=int(seeds[i]), **filt)

    jsrv = JaxServer(jparams, jcfg, JaxServeConfig(**sc))
    for i, p in enumerate(prompts):
        jsrv.submit(p, **kw(i))
    want = jsrv.run()
    srv = Server(tparams, tcfg, ServeConfig(**sc), device="cpu")
    for i, p in enumerate(prompts):
        srv.submit(p, **kw(i))
    ref = srv.run()
    assert ref == want

    for planes, extra in ((1, {}), (2, {}), (1, dict(block_size=4))):
        eng = ServeEngine(tparams, tcfg, ServeConfig(**sc, **extra), planes=planes,
                          device="cpu")
        rids = [eng.submit(p, **kw(i)) for i, p in enumerate(prompts)]
        got = eng.run()
        for i, rid in enumerate(rids):
            assert got[rid] == ref[i], f"request {i} diverged (planes={planes}, {extra})"


@pytest.mark.parametrize("example_seed", [0, 7, 23])
def test_server_and_engines_equal_the_jax_server_at_temperature(lm_setup, example_seed):
    """For a random request set at temperature > 0 (per-request seeds; every
    other request filtered by top-k and top-p), the port's Server generates
    the JAX Server's tokens, and every engine shape (1 plane, 2 planes,
    paged) generates the port Server's."""
    _check_servers_at_temperature(lm_setup, example_seed)


@pytest.mark.parametrize("example_seed", [0, 7, 23])
def test_server_and_engines_equal_the_jax_server_at_temperature_in_bf16(example_seed):
    """The same in bf16, the served archs' dtype.  The two packages' bf16
    logits are not bit-equal (their matmuls and norms round in other
    orders), so beside the sampler this holds that no draw of these
    requests lies within such a rounding of a tie."""
    _check_servers_at_temperature(bridge("qwen1.5-4b", seed=1, dtype="bfloat16"),
                                  example_seed)


def test_sampled_run_differs_from_greedy_and_defaults_apply(lm_setup):
    """A config-level temperature samples (not the greedy tokens), and two
    engines with the same seeds agree."""
    _, tcfg, _, tparams = lm_setup
    prompts = [np.array([3, 1, 4, 1, 5], np.int32), np.array([2, 7, 1, 8, 2], np.int32)]
    outs = {}
    for temp in (0.0, 1.2, 1.2):
        eng = ServeEngine(tparams, tcfg, ServeConfig(slots=2, max_len=48,
                                                     max_new_tokens=6,
                                                     temperature=temp, sample_seed=5,
                                                     top_k=20, top_p=0.95), device="cpu")
        rids = [eng.submit(p) for p in prompts]
        got = eng.run()
        outs.setdefault(temp, []).append([got[r] for r in rids])
    assert outs[1.2][0] == outs[1.2][1]
    assert outs[1.2][0] != outs[0.0][0]


def test_sampled_one_pull_per_decode_step(lm_setup):
    """Sampled lanes add no device→host sync: a sampled engine step costs one
    pull per prefill group and one per decode step, as a greedy one does."""
    from repro_torch.serve import count_transfers

    _, tcfg, _, tparams = lm_setup
    eng = ServeEngine(tparams, tcfg, ServeConfig(slots=4, max_len=48, max_new_tokens=8,
                                                 temperature=0.7, top_k=20), device="cpu")
    for _ in range(4):
        eng.submit(np.array([3, 1, 4, 1, 5], np.int32))
    with count_transfers() as c:
        eng.step()  # 1 batched prefill + 1 decode
    assert c["pulls"] == 2
    with count_transfers() as c:
        eng.step()
    assert c["pulls"] == 1
