"""The port's cost counter (``launch/costs.py``) against the JAX package's
``analyze_hlo``, on the JAX cost tests' programs (``tests/test_launch.py``),
at their ``rel=0.01``; and its per-device view of DTensor programs, its
loop roll-up and its live-memory peak."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import costs as jcosts
from repro_torch.launch import costs
from repro_torch.loops import trips


def _jax_flops(fn, *shapes):
    sds = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jcosts.analyze_hlo(jax.jit(fn).lower(*sds).compile().as_text()).flops


def _scan7(x):
    def body(c, _):
        return c @ c, None
    return jax.lax.scan(body, x, None, length=7)[0]


def _nested(x):
    def inner(c, _):
        return c @ c, None

    def outer(c, _):
        return jax.lax.scan(inner, c, None, length=3)[0], None
    return jax.lax.scan(outer, x, None, length=5)[0]


def _loop7(x):
    for _ in range(7):
        x = x @ x
    return x


def _loop_nested(x):
    for _ in range(5):
        for _ in range(3):
            x = x @ x
    return x


@pytest.mark.parametrize("case", ["scan7", "nested", "einsum"])
def test_flops_equal_analyze_hlo(case):
    rng = np.random.default_rng(0)
    if case == "scan7":
        want = _jax_flops(_scan7, (128, 128))
        _, got = costs.count(_loop7, torch.from_numpy(rng.standard_normal((128, 128))).float())
        assert want == pytest.approx(7 * 2 * 128**3, rel=0.01)
    elif case == "nested":
        want = _jax_flops(_nested, (64, 64))
        _, got = costs.count(_loop_nested, torch.randn(64, 64))
        assert want == pytest.approx(15 * 2 * 64**3, rel=0.01)
    else:
        want = _jax_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                          (4, 32, 64), (4, 64, 16))
        _, got = costs.count(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                             torch.randn(4, 32, 64), torch.randn(4, 64, 16))
    assert got.flops == pytest.approx(want, rel=0.01)


def test_linear_and_conv_flops():
    x, w, b = torch.randn(8, 32), torch.randn(16, 32), torch.randn(16)
    _, c = costs.count(torch.nn.functional.linear, x, w, b)  # addmm
    assert c.flops == 2 * 8 * 32 * 16
    img, ker = torch.randn(2, 3, 10, 10), torch.randn(4, 3, 3, 3)
    _, c = costs.count(torch.nn.functional.conv2d, img, ker)
    assert c.flops == 2 * (2 * 4 * 8 * 8) * (3 * 3 * 3)


def test_bytes_of_a_loop_over_a_stack_are_slice_sized():
    """Per-iteration traffic is the slice's, not the whole stack's."""
    stack = torch.randn(100, 256, 256)

    def f(stack):
        c = torch.zeros(256, 256)
        for i in range(100):
            c = c + stack[i]
        return c

    _, c = costs.count(f, stack)
    slice_bytes = 256 * 256 * 4
    assert c.bytes == 100 * 3 * slice_bytes + slice_bytes  # 2 reads + 1 write, zeros
    assert c.bytes < 100 * 10 * slice_bytes


def test_trips_roll_a_loop_up_by_its_trip_count():
    ran = []

    def f(x, n):
        for i in trips(n):
            ran.append(i)
            x = torch.tanh(x @ x)
        return x

    x = torch.empty(32, 32, device="meta")  # a rolling counter counts meta shards
    with torch.no_grad():
        _, unrolled = costs.count(f, x, 6)
        assert ran == list(range(6))
        ran.clear()
        _, rolled = costs.count(f, x, 6, roll=True)
        assert ran == [0, 1]  # two trips ran, the second counted five times
    assert rolled.flops == unrolled.flops == 6 * 2 * 32**3
    assert rolled.bytes == unrolled.bytes
    assert rolled.peak_bytes == unrolled.peak_bytes
    # a loop feeding one autograd graph is not rolled while gradients are on
    ran.clear()
    with torch.enable_grad():
        _, c = costs.count(f, x.clone().requires_grad_(), 6, roll=True)
    assert ran == list(range(6))
    assert c.flops == 6 * 2 * 32**3
    # a rolled loop computes two trips: real arguments are refused, and a
    # loop rolls only once the arguments are known to be meta
    with torch.no_grad(), pytest.raises(ValueError, match="meta shards only"):
        costs.count(f, torch.randn(32, 32), 6, roll=True)
    with torch.no_grad(), pytest.raises(RuntimeError, match="track"):
        with costs.CostCounter(roll=True):
            f(torch.randn(32, 32), 6)
    # outside a rolling counter the loop runs every trip
    want = torch.eye(4)
    for _ in range(3):
        want = torch.tanh(want @ want)
    assert torch.equal(f(torch.eye(4), 3), want)


def test_rolled_kv_loop_counts_what_the_unrolled_loop_counts():
    """Blockwise attention's kv loop, rolled as the dry-run rolls it, counts
    the FLOPs, bytes and live-memory peak of the same call unrolled; on real
    tensors outside a counter it computes what full attention computes."""
    from repro_torch.models.lm.attention import blockwise_attention, full_attention

    shapes = ((2, 256, 4, 16), (2, 256, 2, 16), (2, 256, 2, 16))
    meta = [torch.empty(s, device="meta") for s in shapes]
    kw = dict(causal=True, q_chunk=64, kv_chunk=32)
    with torch.no_grad():
        _, unrolled = costs.count(blockwise_attention, *meta, **kw)
        _, rolled = costs.count(blockwise_attention, *meta, roll=True, **kw)
    assert rolled.flops == unrolled.flops > 0
    assert rolled.bytes == unrolled.bytes
    assert rolled.peak_bytes == unrolled.peak_bytes
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(s, generator=g) for s in shapes)
    torch.testing.assert_close(blockwise_attention(q, k, v, **kw),
                               full_attention(q, k, v, causal=True),
                               atol=1e-5, rtol=1e-4)


def test_peak_of_live_storage():
    mb = 2**20

    def f(x):
        y = x * 2  # x, y live
        z = y + 1  # x, y, z live: the peak
        del y
        return z * 3  # x, z, out live

    x = torch.empty(mb // 4)
    _, c = costs.count(f, x)
    assert c.argument_bytes == mb
    assert c.peak_bytes == 3 * mb
    # CUDA blocks: every storage rounds up to 512 bytes
    _, c = costs.count(lambda t: (t + 1, t + 2), torch.empty(3), block=costs.CUDA_BLOCK)
    assert c.peak_bytes == 3 * 512


def test_views_move_nothing_and_share_storage():
    x = torch.randn(64, 64)
    _, c = costs.count(lambda t: t.T.reshape(-1)[:10].unsqueeze(0), x)
    assert c.bytes == 64 * 64 * 4 * 2  # the reshape of a transposed view copies
    assert c.flops == 0


@pytest.fixture
def fake16():
    """A fake process group of 16 ranks and a (4, 4) CPU mesh, torn down
    after the test."""
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import init_fake_group

    init_fake_group(16)
    try:
        yield M.device_mesh(M.MeshSpec(("data", "model"), (4, 4)), "cpu")
    finally:
        dist.destroy_process_group()


def test_dtensor_ops_count_per_device(fake16):
    """A DTensor matmul counts its local shard's FLOPs, not the global op's
    (``FlopCounterMode`` counts the global one), and the collective its
    redistribution issues, at the result's per-device bytes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = DTensor.from_local(torch.empty(8, 256, device="meta"), fake16,
                           [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(256, 64, device="meta"), fake16,
                           [Replicate(), Shard(1)], run_check=False)
    counter = costs.CostCounter()
    with counter:
        y = x @ w  # [32, 256] sharded (data, model): local [8, 64]
        full = y.redistribute(fake16, [Replicate(), Replicate()])
    c = counter.costs
    assert c.flops == 2 * 8 * 256 * 64
    assert tuple(full.to_local().shape) == (32, 256)
    # one all-gather a mesh axis: [8, 256] or [32, 64], then [32, 256]
    assert c.coll_by_op["all-gather"] == (8 * 256 + 32 * 256) * 4
    assert c.coll_counts["all-gather"] == 2
    assert c.coll_bytes == c.coll_by_op["all-gather"]
