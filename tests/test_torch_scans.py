"""The LM family's scans as the JAX package runs them.

- ``loops.associative_scan`` is ``jax.lax.associative_scan``'s recursion:
  with RG-LRU's combine its ``h`` equals JAX's bit for bit.  Its decay
  products do too once denormals are flushed, as XLA's CPU backend flushes
  them (left on, a product that underflows stays subnormal here, where
  JAX's is 0).
- ``rglru_scan`` has the JAX function's branches.  On the same ``(a, b)``
  (both packages' ``_gates`` replaced by one shim, since the gates'
  matmuls round otherwise in the two frameworks), ``use_assoc=True`` with
  and without ``h0`` equals JAX's bit for bit.  ``use_assoc=False`` equals
  a float32 loop that rounds the product and the sum (the CUDA kernel's
  arithmetic) bit for bit, and JAX's within atol = rtol = 1e-5 (the LM
  parity tolerance): XLA's CPU backend contracts the ``lax.scan`` step's
  multiply-add into one FMA, one rounding a step where the port has two.
  The block's cache branch is sequential, as JAX's is.
- The WKV scan as an autograd function: its forward equals the old
  autograd loop (kept here as the oracle) bit for bit, its gradients lie
  within atol 1e-5 plus rtol 1e-4 of ``jax.grad`` of JAX's ``_wkv_scan``
  (the tolerance of ``tests/test_torch_rwkv6.py``), and ``gradcheck``
  passes in float64.
- Under a rolling ``CostCounter`` the WKV's forward and backward loops and
  the sequential RG-LRU scan run two trips, and the counts (FLOPs, bytes,
  collectives, peak) equal the unrolled ones, on smoke cells of a fake
  2 x 2 mesh.
- On DTensor operands the associative scan runs on local shards, a split
  sequence made whole first (a one-rank gloo mesh, values and gradients).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.models.lm import rglru as jrglru
from repro.models.lm import rwkv6 as jrwkv
from repro_torch import loops
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels.linear_scan.ops import scan_on_whole_sequences
from repro_torch.launch import dryrun, specs
from repro_torch.launch import mesh as M
from repro_torch.launch.costs import CostCounter
from repro_torch.models.lm import rglru as trglru
from repro_torch.models.lm import rwkv6 as trwkv

WKV_ATOL, WKV_RTOL = 1e-5, 1e-4


def _combine(l, r):
    return l[0] * r[0], l[1] * r[0] + r[1]


def _decays(rng, shape):
    return rng.uniform(0.5, 1.0, shape).astype(np.float32)


# ------------------------------------------------------- associative scan
@pytest.mark.parametrize("s", [1, 2, 3, 7, 64, 129, 1000, 4096])
def test_associative_scan_equals_jax_bit_for_bit(s):
    rng = np.random.default_rng(s)
    a, b = _decays(rng, (2, s, 33)), rng.standard_normal((2, s, 33)).astype(np.float32)
    ja, jh = jax.lax.associative_scan(_combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    ta, th = loops.associative_scan(_combine, (torch.from_numpy(a), torch.from_numpy(b)),
                                    dim=1)
    assert np.array_equal(th.numpy(), np.asarray(jh))
    ja, ta = np.asarray(ja), ta.numpy()
    differ = ja != ta
    assert np.all(ja[differ] == 0) and np.all(np.abs(ta[differ]) < np.finfo(np.float32).tiny)
    was = torch.set_flush_denormal(True)
    try:
        ta, th = loops.associative_scan(_combine, (torch.from_numpy(a), torch.from_numpy(b)),
                                        dim=1)
    finally:
        torch.set_flush_denormal(was)
    assert np.array_equal(ta.numpy(), ja) and np.array_equal(th.numpy(), np.asarray(jh))


def test_associative_scan_on_a_leading_dim_and_its_gradient():
    """Any dim; the scan is differentiable (the associative training path):
    its gradient matches the sequential loop's."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_decays(rng, (37, 3))).requires_grad_()
    b = torch.from_numpy(rng.standard_normal((37, 3)).astype(np.float32)).requires_grad_()
    _, h = loops.associative_scan(_combine, (a, b), dim=0)
    want, hh = [], torch.zeros(3)
    for t in range(37):
        hh = a[t] * hh + b[t]
        want.append(hh)
    want = torch.stack(want)
    torch.testing.assert_close(h, want, atol=1e-6, rtol=1e-5)
    g = torch.from_numpy(rng.standard_normal((37, 3)).astype(np.float32))
    for got, exp in zip(torch.autograd.grad((h * g).sum(), (a, b)),
                        torch.autograd.grad((want * g).sum(), (a, b))):
        torch.testing.assert_close(got, exp, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------- RG-LRU
@pytest.fixture
def shim(monkeypatch):
    """Both packages' ``_gates`` return the same seeded ``(a, b)``."""
    rng = np.random.default_rng(7)
    a, b = _decays(rng, (2, 300, 24)), rng.standard_normal((2, 300, 24)).astype(np.float32)
    monkeypatch.setattr(jrglru, "_gates", lambda p, x: (jnp.asarray(a), jnp.asarray(b)))
    monkeypatch.setattr(trglru, "_gates", lambda p, x: (torch.from_numpy(a),
                                                          torch.from_numpy(b)))
    x = np.zeros((2, 300, 24), np.float32)  # sets the dtype only
    h0 = rng.standard_normal((2, 24)).astype(np.float32)
    return x, h0, a, b


def _both_scans(shim, with_h0, use_assoc):
    x, h0, _, _ = shim
    jy, jlast = jrglru.rglru_scan(None, jnp.asarray(x),
                                  h0=jnp.asarray(h0) if with_h0 else None,
                                  use_assoc=use_assoc)
    ty, tlast = trglru.rglru_scan(None, torch.from_numpy(x),
                                  h0=torch.from_numpy(h0) if with_h0 else None,
                                  use_assoc=use_assoc)
    return (ty.numpy(), tlast.numpy()), (np.asarray(jy), np.asarray(jlast))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_scan_assoc_equals_jax_bit_for_bit(shim, with_h0):
    (ty, tlast), (jy, jlast) = _both_scans(shim, with_h0, True)
    assert np.array_equal(ty, jy) and np.array_equal(tlast, jlast)


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_scan_sequential_rounds_each_op_and_matches_jax(shim, with_h0):
    (ty, tlast), (jy, jlast) = _both_scans(shim, with_h0, False)
    _, h0, a, b = shim
    h = h0 if with_h0 else np.zeros_like(h0)
    want = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]  # float32: a rounded product, a rounded sum
        want.append(h)
    assert np.array_equal(ty, np.stack(want, 1)) and np.array_equal(tlast, want[-1])
    np.testing.assert_allclose(ty, jy, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tlast, jlast, atol=1e-5, rtol=1e-5)


def test_rglru_block_takes_the_sequential_scan_with_a_cache(monkeypatch):
    """As JAX's block (its :103): the cache branch passes ``use_assoc=False``,
    the branch without a cache the default."""
    cfg = get_arch("recurrentgemma-2b").smoke_config()
    p = trglru.init_rglru_block(lambda shape: torch.randn(shape), cfg)
    seen = []
    scan = trglru.rglru_scan
    monkeypatch.setattr(trglru, "rglru_scan",
                        lambda *a, **kw: seen.append(kw.get("use_assoc", True)) or scan(*a, **kw))
    x = torch.randn(2, 5, cfg.d_model)
    trglru.rglru_block(p, cfg, x)
    trglru.rglru_block(p, cfg, x, cache=trglru.init_rglru_cache(cfg, 2, torch.float32, "cpu"))
    assert seen == [True, False]


def test_assoc_scan_on_dtensors_makes_a_split_sequence_whole():
    """A one-rank gloo mesh with the sequence placed ``Shard(1)``: the scan
    runs on the local shard after the split is made whole, keeps the other
    placements, and gives the plain tensors' values and gradients."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rng = np.random.default_rng(3)
    a, b = _decays(rng, (2, 17, 8)), rng.standard_normal((2, 17, 8)).astype(np.float32)
    want = trglru._assoc_scan(torch.from_numpy(a), torch.from_numpy(b))[0]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        dm = M.device_mesh(M.MeshSpec(("data", "model"), (1, 1)), "cpu")
        la, lb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
        da, db = (DTensor.from_local(t, dm, [Shard(0), Shard(1)], run_check=False)
                  for t in (la, lb))
        h, _ = scan_on_whole_sequences(trglru._assoc_scan, da, db, None)
        assert tuple(h.placements) == (Shard(0), Replicate())
        assert torch.equal(h.full_tensor(), want)
        ga, gb = torch.autograd.grad(h.to_local().sum(), (la, lb))
        pa, pb = (torch.from_numpy(t).requires_grad_() for t in (a, b))
        wa, wb = torch.autograd.grad(trglru._assoc_scan(pa, pb)[0].sum(), (pa, pb))
        assert torch.equal(ga, wa) and torch.equal(gb, wb)
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------------- WKV
def _old_wkv(r, k, v, w, u, s0):
    """The WKV loop under autograd, as the port ran it before the scan
    became an autograd function."""
    s = s0
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        bonus = torch.sum(rt * u * kt, dim=-1, keepdim=True)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s) + bonus * vt)
        s = wt[..., :, None] * s + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=1), s


def _wkv_inputs(seed, b, s, h, hs, dtype=np.float32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, hs)).astype(dtype) for _ in range(3))
    w = rng.uniform(0.2, 0.99, (b, s, h, hs)).astype(dtype)
    u = (rng.standard_normal((h, hs)) * 0.1).astype(dtype)
    s0 = rng.standard_normal((b, h, hs, hs)).astype(dtype)
    return [r, k, v, w, u, s0]


@pytest.mark.parametrize("grad", [True, False], ids=["function", "no-grad"])
@pytest.mark.parametrize("shape", [(2, 1, 3, 8), (2, 9, 3, 8), (1, 33, 2, 16)])
def test_wkv_forward_equals_the_old_loop_bit_for_bit(shape, grad):
    xs = [torch.from_numpy(a).requires_grad_(grad) for a in _wkv_inputs(1, *shape)]
    out, s_last = trwkv._wkv_scan(*xs)
    assert (out.grad_fn is not None) == grad
    with torch.no_grad():
        want_out, want_s = _old_wkv(*xs)
    assert torch.equal(out, want_out) and torch.equal(s_last, want_s)


@pytest.mark.parametrize("s", [1, 12])
def test_wkv_gradients_match_jax_grad(s):
    """Every input's gradient (``s0`` too) of a loss on both outputs."""
    xs = _wkv_inputs(2, 2, s, 3, 8)
    rng = np.random.default_rng(5)
    g_out = rng.standard_normal((2, s, 3, 8)).astype(np.float32)
    g_s = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)

    def jloss(*a):
        out, s_last = jrwkv._wkv_scan(*a)
        return jnp.sum(out * g_out) + jnp.sum(s_last * g_s)

    jg = jax.grad(jloss, argnums=tuple(range(6)))(*map(jnp.asarray, xs))
    ts = [torch.from_numpy(a).requires_grad_() for a in xs]
    out, s_last = trwkv._wkv_scan(*ts)
    tg = torch.autograd.grad((out * torch.from_numpy(g_out)).sum()
                             + (s_last * torch.from_numpy(g_s)).sum(), ts)
    for name, got, want in zip("r k v w u s0".split(), tg, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=WKV_ATOL,
                                   rtol=WKV_RTOL, err_msg=name)


def test_wkv_gradcheck_float64():
    xs = [torch.from_numpy(a).requires_grad_() for a in _wkv_inputs(4, 1, 5, 2, 4, np.float64)]
    assert torch.autograd.gradcheck(trwkv._WKV.apply, xs)


# ------------------------------------------------------------------ rolls
class _Trips:
    """Records each ``trips`` loop: (n, trips run)."""

    def __init__(self):
        self.loops = []

    def __call__(self, n, **kw):
        rec = [n, 0]
        self.loops.append(rec)
        for i in loops.trips(n, **kw):
            rec[1] += 1
            yield i


@pytest.mark.parametrize("arch_id,kind,seq", [
    ("rwkv6-1.6b", "train", 16),
    ("rwkv6-1.6b", "prefill", 16),
    ("recurrentgemma-2b", "train", 32),
    ("recurrentgemma-2b", "prefill", 32),
])
def test_rolled_scans_count_what_the_unrolled_scans_count(monkeypatch, arch_id, kind, seq):
    """A smoke cell on a fake 2 x 2 mesh, counted with the loops rolled (as
    the dry-run counts) and unrolled: equal FLOPs, bytes, collectives and
    peak.  Rolled, every WKV loop (forward and, in training, backward) and
    every sequential RG-LRU scan runs two trips; RG-LRU training runs none."""
    from repro_torch.kernels.linear_scan import ref

    rec = _Trips()
    monkeypatch.setattr(trwkv, "trips", rec)
    monkeypatch.setattr(ref, "trips", rec)
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, lm=arch.smoke_config())
    mesh = M.MeshSpec(("data", "model"), (2, 2))
    cell = ShapeCell(f"{kind}_s", kind, seq, 4)
    prog = (specs.build_lm_train(arch, cell, mesh, microbatches=2) if kind == "train"
            else specs.build_lm_prefill(arch, cell, mesh))
    dryrun.init_fake_group(4)
    try:
        dm = M.device_mesh(mesh, "cpu")
        counted, ran = [], []
        for roll in (False, True):
            rec.loops.clear()
            counter = CostCounter(roll=roll)
            args = specs.place_args(prog, dm, specs.empty_local("meta"))
            counter.track(args)
            with counter:
                prog.fn(*args)
            counted.append(counter.costs)
            ran.append([tuple(r) for r in rec.loops if r[0] > 1])
            del args
    finally:
        dist.destroy_process_group()
    unrolled, rolled = counted
    assert rolled.flops == unrolled.flops > 0
    assert rolled.bytes == unrolled.bytes
    assert rolled.coll_by_op == unrolled.coll_by_op
    assert rolled.coll_counts == unrolled.coll_counts
    assert rolled.peak_bytes == unrolled.peak_bytes
    # RG-LRU training takes the associative scan: no sequential loop
    assert bool(ran[0]) == (arch_id == "rwkv6-1.6b" or kind == "prefill")
    assert all(n == t for n, t in ran[0])
    assert [n for n, _ in ran[1]] == [n for n, _ in ran[0]]
    assert all(t == 2 for _, t in ran[1])
