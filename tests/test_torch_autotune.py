"""The port's measured dispatcher: bucketing, cache robustness, mode
semantics (the cases of tests/test_autotune.py), and parity with the JAX
package's dispatcher on the CPU.

The tuning cache is optional: a missing, truncated, corrupt or
foreign-backend ``TUNING_<backend>.json`` never crashes dispatch.  The
port's cache lives under ``build/tuning``, never in ``results/``, where the
JAX tuner's committed ``TUNING_cpu.json`` shares the backend key ``cpu``.
"""
import hashlib
import json
import os
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import autotune as jax_autotune
from repro.models import pgt_dcrnn as jm
from repro_torch.core import WindowSpec
from repro_torch.data import (gaussian_adjacency, make_traffic_series,
                              random_sensor_coords, transition_matrices)
from repro_torch.interop import params_from_jax
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import (OpSpec, Variant, autotuning, bucket_key,
                                          cache_path, dispatch, load_cache,
                                          pow2_bucket, reset_autotune, save_cache,
                                          set_autotune, verdict_for)
from repro_torch.kernels.window_gather.ref import window_gather_ref
from repro_torch.models import pgt_dcrnn as tm
from repro_torch.optim import AdamConfig
from repro_torch.pipeline import PipelineConfig, build_pipeline
from repro_torch.train import TrainLoopConfig

ROOT = Path(__file__).resolve().parents[1]
JAX_CACHE = ROOT / "results" / "TUNING_cpu.json"
JAX_CACHE_DIGEST = (hashlib.sha256(JAX_CACHE.read_bytes()).hexdigest()
                    if JAX_CACHE.exists() else None)


@pytest.fixture(autouse=True)
def _clean_policy():
    reset_autotune()
    jax_autotune.reset_autotune()
    yield
    reset_autotune()
    jax_autotune.reset_autotune()


def _wg_args(t=64, c=8, b=4, span=6):
    rng = np.random.default_rng(0)
    series = torch.as_tensor(rng.standard_normal((t, c)).astype(np.float32))
    starts = torch.as_tensor(rng.integers(0, t - span + 1, b).astype(np.int32))
    return series, starts, span


# ------------------------------------------------------------ shape bucketing
def test_pow2_bucket_envelopes():
    assert [pow2_bucket(n) for n in (0, 1, 2, 3, 5, 16, 17, 1000)] == \
        [1, 1, 2, 4, 8, 16, 32, 1024]


def test_bucket_key_is_stable_and_backend_scoped():
    k = bucket_key("window_gather", "cpu", {"t": 512, "c": 64}, torch.float32)
    assert k == "window_gather|cpu|t=512,c=64|float32"
    assert bucket_key("window_gather", "cuda", {"t": 512, "c": 64},
                      torch.float32) != k


@pytest.mark.parametrize("op,dims,dtype", [
    ("window_gather", {"t": 8640, "c": 5432, "b": 32, "span": 24}, "float32"),
    ("flash_attention", {"b": 2, "s": 512, "h": 10, "hkv": 1, "d": 256}, "bfloat16"),
    ("linear_scan", {"b": 8, "s": 1, "d": 2560}, "float32"),
    ("gather", {"t": 300, "c": 7, "b": 6, "span": 10}, "int32"),
])
def test_bucket_key_equals_jax(op, dims, dtype):
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    assert bucket_key(op, "cpu", dims, tdt) == jax_autotune.bucket_key(op, "cpu", dims, jdt)


def test_same_bucket_shares_one_verdict(tmp_path):
    """Shapes inside one power-of-two envelope resolve to the same entry."""
    with autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        s1, st1, span = _wg_args(t=40, c=8)
        s2, st2, _ = _wg_args(t=60, c=7)
        dispatch("window_gather", s1, st1, span=span)
        n_after_first = len(load_cache(cache_path("cpu", str(tmp_path)), "cpu"))
        dispatch("window_gather", s2, st2, span=span)
        n_after_second = len(load_cache(cache_path("cpu", str(tmp_path)), "cpu"))
    assert n_after_first == n_after_second == 1


# --------------------------------------------------------------- persistence
def test_cache_round_trip(tmp_path):
    path = cache_path("cpu", str(tmp_path))
    entries = {"op|cpu|t=64|float32": {"variant": "ref", "params": {}, "us": 1.5}}
    save_cache(path, "cpu", entries)
    assert load_cache(path, "cpu") == entries
    raw = json.loads(Path(path).read_text())
    assert raw["torch"] == torch.__version__ and raw["device"] and "jax" not in raw


def test_save_merges_with_existing_entries(tmp_path):
    path = cache_path("cpu", str(tmp_path))
    save_cache(path, "cpu", {"a|cpu|t=1|f32": {"variant": "x", "params": {}}})
    save_cache(path, "cpu", {"b|cpu|t=2|f32": {"variant": "y", "params": {}}})
    assert set(load_cache(path, "cpu")) == {"a|cpu|t=1|f32", "b|cpu|t=2|f32"}


def test_missing_cache_loads_empty(tmp_path):
    assert load_cache(cache_path("cpu", str(tmp_path)), "cpu") == {}


def test_torn_cache_at_any_offset_loads_empty(tmp_path):
    """A write torn at ANY byte offset (or trailing garbage) never raises."""
    path = cache_path("cpu", str(tmp_path))
    save_cache(path, "cpu", {"op|cpu|t=64|float32": {
        "variant": "ref", "params": {"block": 128}, "us": 1.5}})
    blob = open(path, "rb").read()
    full = load_cache(path, "cpu")
    assert full
    for cut in range(0, len(blob), max(1, len(blob) // 40)):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        got = load_cache(path, "cpu")  # must not raise
        assert got == {} or got == full
    for garbage in (b"{not json", b"\x00\xff" * 10, b"[1, 2, 3]",
                    b'{"entries": 7}', blob + b"trailing"):
        with open(path, "wb") as f:
            f.write(garbage)
        assert load_cache(path, "cpu") == {}


def test_foreign_backend_cache_ignored(tmp_path):
    path = cache_path("cpu", str(tmp_path))
    save_cache(path, "cuda", {"op|cuda|t=64|float32": {"variant": "pallas",
                                                       "params": {}}})
    assert load_cache(path, "cpu") == {}
    assert load_cache(path, "cuda") != {}


def test_concurrent_writers_never_corrupt(tmp_path):
    """Racing writers: the file parses after every interleaving, and every
    surviving entry is exactly what its writer wrote."""
    path = cache_path("cpu", str(tmp_path))
    written = {f"op{i}|cpu|t=64|float32": {"variant": "ref", "params": {},
                                           "us": float(i)}
               for i in range(16)}
    threads = [threading.Thread(target=save_cache, args=(path, "cpu", {k: v}))
               for k, v in written.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = load_cache(path, "cpu")
    assert got
    for key, entry in got.items():
        assert entry == written[key]
    with open(path) as f:
        assert json.load(f)["backend"] == "cpu"


# ------------------------------------------------------------- mode semantics
def test_mode_off_uses_static_default():
    series, starts, span = _wg_args()
    with autotuning(mode="off"):
        v = verdict_for("window_gather", series, starts, span=span)
    assert v.source == "default" and v.variant == "ref"


def test_mode_load_without_cache_falls_back_to_default(tmp_path):
    series, starts, span = _wg_args()
    with autotuning(mode="load", cache_dir=str(tmp_path)):
        v = verdict_for("window_gather", series, starts, span=span)
        out = dispatch("window_gather", series, starts, span=span)
    assert v.source == "default"
    assert torch.equal(out, window_gather_ref(series, starts, span=span))
    assert not os.path.exists(cache_path("cpu", str(tmp_path)))


def test_tune_persists_and_load_reads_back(tmp_path):
    series, starts, span = _wg_args()
    with autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        tuned = verdict_for("window_gather", series, starts, span=span)
    assert tuned.source == "tuned"
    assert os.path.exists(cache_path("cpu", str(tmp_path)))
    with autotuning(mode="load", cache_dir=str(tmp_path)):
        loaded = verdict_for("window_gather", series, starts, span=span)
    assert loaded.source == "cache"
    assert (loaded.variant, loaded.params) == (tuned.variant, tuned.params)


@pytest.mark.parametrize("entry", [{"variant": "does_not_exist", "params": {}},
                                   {"variant": "ref", "params": {"gather_threads": 96}}])
def test_stale_cached_variant_falls_back_cleanly(tmp_path, caplog, entry):
    """A cache naming a variant that no longer exists, or params outside the
    current grid, dispatches the default and says so."""
    series, starts, span = _wg_args()
    key = bucket_key("window_gather", "cpu",
                     {"t": series.shape[0], "c": series.shape[1],
                      "b": len(starts), "span": span}, series.dtype)
    save_cache(cache_path("cpu", str(tmp_path)), "cpu", {key: entry})
    with autotuning(mode="load", cache_dir=str(tmp_path)):
        out = dispatch("window_gather", series, starts, span=span)
    assert torch.equal(out, window_gather_ref(series, starts, span=span))
    assert "stale cache entry" in caplog.text


def test_set_autotune_rejects_unknown_mode():
    with pytest.raises(ValueError):
        set_autotune(mode="sometimes")


# -------------------------------------------- what the port does not hide
def _spec_with(pallas_fn, exact=True):
    base = autotune._OPS["window_gather"]
    return OpSpec(name="window_gather", describe=base.describe, synth=base.synth,
                  default=base.default,
                  variants=lambda: (base.variants()[0],
                                    Variant("pallas", lambda static, params: pallas_fn,
                                            exact=exact)))


def test_failing_candidate_raises_instead_of_being_rejected(tmp_path, monkeypatch):
    def broken(series, starts):
        raise RuntimeError("kernel did not launch")

    monkeypatch.setitem(autotune._OPS, "window_gather", _spec_with(broken))
    series, starts, span = _wg_args()
    with autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        with pytest.raises(RuntimeError, match="did not launch"):
            dispatch("window_gather", series, starts, span=span)


def test_wrong_candidate_is_rejected_and_logged(tmp_path, monkeypatch, caplog):
    def off_by_one(series, starts):
        return window_gather_ref(series, starts + 1, span=6)

    monkeypatch.setitem(autotune._OPS, "window_gather", _spec_with(off_by_one))
    series, starts, span = _wg_args()
    with autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        v = verdict_for("window_gather", series, starts, span=span)
    entry = load_cache(cache_path("cpu", str(tmp_path)), "cpu")
    (cands,) = [e["candidates"] for e in entry.values()]
    assert v.variant == "ref" and "values diverge" in cands["pallas"]["rejected"]
    assert "rejected pallas" in caplog.text


def test_bf16_admission_allows_one_spacing_at_each_output():
    """Two bf16 results one spacing apart at each output pass the flash
    tolerance; two spacings apart do not, nor does one spacing at the
    largest output where the output is small, nor one float32 result that
    far from another."""
    var = Variant("pallas", None, exact=False, atol=2e-3, rtol=2e-3)
    ref = torch.tensor([1.0, 0.5, 0.0, 4.0], dtype=torch.bfloat16)
    one = torch.tensor([1.0078125, 0.50390625, 0.0, 4.03125], dtype=torch.bfloat16)
    two = torch.tensor([1.015625, 0.5, 0.0, 4.0], dtype=torch.bfloat16)
    small = torch.tensor([1.0, 0.5, 0.03125, 4.0], dtype=torch.bfloat16)
    assert autotune._admission(ref, one, var)[0] is None
    assert autotune._admission(ref, two, var)[0] is not None
    assert autotune._admission(ref, small, var)[0] is not None
    assert autotune._admission(ref.float(), one.float(), var)[0] is not None


def test_flash_admission_covers_bf16_probabilities():
    """The flash kernel rounds p to bf16 before P·V (as the JAX kernel
    does): emulated here, that rounding breaks the JAX tolerances alone,
    and the flash variant's slack (2^-8 times the attention of |v|) admits
    it; the same rounding of a float32 output is not admitted."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    rng = np.random.default_rng(3)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 64, 2, 32)).astype(np.float32)
                               * scale).bfloat16() for scale in (2.0, 2.0, 4.0))
    qt, kt, vt = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) / 32 ** 0.5
    s = s.masked_fill(~torch.ones(64, 64, dtype=torch.bool).tril(), -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    emulated = ((p.bfloat16().float() @ vt) / p.sum(-1, keepdim=True)).transpose(1, 2)
    ref = flash_attention_ref(*(t.transpose(1, 2) for t in (q, k, v))).transpose(1, 2)
    (var,) = [x for x in autotune._OPS["flash_attention"].variants() if x.kernel]
    slack = var.slack((q, k, v), {"causal": True})
    why, stats = autotune._admission(ref, emulated.bfloat16(), var, slack)
    assert why is None and stats["of_jax_tol"] > 1.0 >= stats["of_allowance"]
    assert var.slack((q.float(), k.float(), v.float()), {"causal": True}) == 0.0


def test_card_candidates_are_the_kernels_alone():
    """On a CUDA tensor only the kernel competes (the plain version is the
    oracle); on the CPU every variant does, the reference first."""
    for name, spec in autotune._OPS.items():
        assert [v.name for v in autotune._candidates(spec, "cuda")] == ["pallas"], name
        cpu = autotune._candidates(spec, "cpu")
        assert [v.name for v in cpu] == [v.name for v in spec.variants()], name
        assert cpu[0].name in ("ref", "slice") and len(cpu) > 1, name


def test_default_cache_dir_is_not_results():
    d = Path(autotune.autotune_policy().cache_dir)
    assert d == ROOT / "build" / "tuning"
    assert d.resolve() != (ROOT / "results").resolve()


# --------------------------------------------------- parity with the JAX side
def _op_cases():
    rng = np.random.default_rng(11)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    adj = rng.uniform(0, 1, (24, 24)).astype(np.float32)
    sup = (adj / adj.sum(1, keepdims=True), adj.T / adj.T.sum(1, keepdims=True))
    starts = rng.integers(0, 50, 5).astype(np.int32)
    return {  # op -> (args, static, atol); the gathers are bit-exact
        "window_gather": ((f(60, 3, 2), starts), {"span": 10}, 0.0),
        "gather": ((f(60, 3, 2), starts), {"input_len": 4, "horizon": 6}, 0.0),
        "linear_scan": ((rng.uniform(0.7, 1.0, (2, 20, 9)).astype(np.float32),
                         f(2, 20, 9), np.zeros((2, 9), np.float32)), {}, 1e-5),
        "flash_attention": ((f(1, 40, 4, 16), f(1, 40, 2, 16), f(1, 40, 2, 16)),
                            {"causal": True}, 5e-5),
        "diffusion_conv": ((f(3, 24, 5), sup, f(25, 6) * 0.3, f(6)),
                           {"k_hops": 2, "n_supports": 2}, 2e-4),
    }


def _to(args, conv):
    return tuple(tuple(conv(a) for a in x) if isinstance(x, tuple) else conv(x)
                 for x in args)


@pytest.mark.parametrize("mode", ["off", "tune"])
@pytest.mark.parametrize("op", sorted(_op_cases()))
def test_dispatch_matches_jax_dispatch(op, mode, tmp_path):
    args, static, atol = _op_cases()[op]
    with jax_autotune.autotuning(mode=mode, cache_dir=str(tmp_path / "jax"),
                                 warmup=0, iters=1):
        want = jax_autotune.dispatch(op, *_to(args, jnp.asarray), **static)
    with autotuning(mode=mode, cache_dir=str(tmp_path / "torch"), warmup=0, iters=1):
        got = dispatch(op, *_to(args, torch.as_tensor), **static)
    for g, w in zip(autotune._leaves(got), jax.tree.leaves(want)):
        if atol == 0.0:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-4)


def test_cpu_default_verdicts_equal_jax():
    cases = _op_cases()
    with jax_autotune.autotuning(mode="off"), autotuning(mode="off"):
        for op, (args, static, _) in cases.items():
            jv = jax_autotune.verdict_for(op, *_to(args, jnp.asarray), **static)
            tv = verdict_for(op, *_to(args, torch.as_tensor), **static)
            assert tv.variant == jv.variant, op
            assert tv.source == jv.source == "default"


def test_gather_auto_trains_like_slice(tmp_path):
    """gather="auto" through build_pipeline on the CPU: the same loss
    trajectory as gather="slice", bit for bit (every gather is bit-exact)."""
    nodes, horizon = 12, 4
    series = make_traffic_series(240, nodes)
    sup = tuple(torch.as_tensor(s) for s in
                transition_matrices(gaussian_adjacency(random_sensor_coords(nodes))))
    kw = dict(num_nodes=nodes, hidden=8, input_len=horizon, horizon=horizon)
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0), jm.PGTDCRNNConfig(**kw)))
    cfg = tm.PGTDCRNNConfig(**kw)

    def losses(gather):
        pipe = build_pipeline(
            series, WindowSpec(horizon=horizon),
            lambda p, x, y: (tm.loss_fn(p, cfg, sup, x, y), {}),
            params_from_jax(jparams, device="cpu"),
            PipelineConfig(batch_per_rank=8, gather=gather, seed=1, device="cpu",
                           adam=AdamConfig(lr=5e-3),
                           loop=TrainLoopConfig(epochs=1, log_every=1)))
        _, history = pipe.fit(eval_fn=None)
        return [r["loss"] for r in history if "epoch_time_s" not in r]

    with autotuning(mode="tune", cache_dir=str(tmp_path), warmup=0, iters=1):
        auto = losses("auto")
    assert len(auto) > 5 and auto == losses("slice")
    (key,) = load_cache(cache_path("cpu", str(tmp_path)), "cpu")
    assert key.startswith("gather|cpu|")


def test_jax_tuning_cache_untouched():
    """Runs last in this file: no test above wrote results/TUNING_cpu.json."""
    assert JAX_CACHE_DIGEST is not None
    assert hashlib.sha256(JAX_CACHE.read_bytes()).hexdigest() == JAX_CACHE_DIGEST


def test_registered_ops_match_jax():
    """The port registers the JAX dispatcher's ops, in its order."""
    assert autotune.registered_ops() == jax_autotune.registered_ops()
    assert set(autotune.registered_ops()) == {
        "window_gather", "gather", "diffusion_conv", "linear_scan", "flash_attention"}
