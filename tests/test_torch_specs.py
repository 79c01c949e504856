"""The port's cell programs against the JAX package's ``launch/specs.py``.

- Every cell of the matrix: ``all_cells()`` equal, and for each cell that is
  not skipped, at both production meshes, ``meta``, the arg shapes and
  dtypes and the in/out specs equal to JAX's ``build_cell``, exactly.
- One step at one rank: from the same parameters (carried across with
  ``interop.params_from_jax``) and the same seeded inputs, the port's cell
  step at a 1×1 mesh gives JAX's ``jax.jit(prog.fn)`` loss and updated
  state, within the tolerances of ``tests/test_torch_dcrnn.py`` and
  ``tests/test_torch_lm_train.py`` (atol 1e-5, rtol 1e-4).  The ST-GNN cell
  is ``test_sharded_stgnn_step_matches_unsharded``'s (12 nodes, series 200)
  under each placement; the LM cell a smoke-config train step.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeCell as JaxShapeCell
from repro.launch import specs as jspecs
from repro.launch.sharding import _path_str
from repro.models import pgt_dcrnn as jpgt
from repro.models.lm import model as jlm
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import mesh as M
from repro_torch.launch import specs
from repro_torch.tree import tree_leaves, tree_paths

ATOL, RTOL = 1e-5, 1e-4
CELLS = [(a, s) for a, s, skip in specs.all_cells() if not skip]


def _jax_mesh(spec: M.MeshSpec) -> Mesh:
    n = M.mesh_chips(spec)
    return Mesh(np.array(jax.devices() * n)[:n].reshape(spec.sizes), spec.axis_names)


def _dt(d) -> str:
    return str(d).replace("torch.", "")


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _port_leaves(tree):
    return tree_leaves(list(tree) if isinstance(tree, tuple) else tree)


def test_all_cells_equal_jax():
    got = list(specs.all_cells())
    assert got == list(jspecs.all_cells())
    assert len(got) == 42
    lm = [c for c in got if get_arch(c[0]).family != "stgnn"]
    assert len(lm) == 40
    skips = [c for c in lm if c[2]]
    assert len(skips) == 7 and all(s[1] == "long_500k" for s in skips)
    assert len(CELLS) == 35


@pytest.mark.parametrize("mp", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch_id,shape", CELLS)
def test_build_cell_equals_jax(arch_id, shape, mp):
    spec = M.make_production_mesh(multi_pod=mp)
    want = jspecs.build_cell(arch_id, shape, _jax_mesh(spec))
    got = specs.build_cell(arch_id, shape, spec)
    assert (got.name, got.kind) == (want.name, want.kind)
    assert got.meta == want.meta
    jargs, pargs = _jax_leaves(want.args), _port_leaves(got.args)
    assert [(tuple(a.shape), _dt(a.dtype)) for a in pargs] == \
        [(tuple(a.shape), str(a.dtype)) for a in jargs]
    for mine, theirs in ((got.in_shardings, want.in_shardings),
                         (got.out_shardings, want.out_shardings)):
        assert [tuple(s.spec) for s in _port_leaves(mine)] == \
            [tuple(s.spec) for s in _jax_leaves(theirs)]


def test_build_cell_paths_equal_jax():
    """The state tree's leaf paths come in JAX's order (the rules read them)."""
    spec = M.make_production_mesh()
    want = jspecs.build_cell("deepseek-v2-lite-16b", "train_4k", _jax_mesh(spec))
    got = specs.build_cell("deepseek-v2-lite-16b", "train_4k", spec)
    flat, _ = jax.tree_util.tree_flatten_with_path(want.args[0])
    assert tree_paths(got.args[0]) == [_path_str(p) for p, _ in flat]


def test_build_cell_refuses_skips_and_unknown_shapes():
    spec = M.make_production_mesh()
    with pytest.raises(ValueError, match="skipped"):
        specs.build_cell("qwen1.5-4b", "long_500k", spec)
    with pytest.raises(KeyError):
        specs.build_cell("qwen1.5-4b", "train_1k", spec)


# ---------------------------------------------------------- one-rank steps
@pytest.fixture
def one_rank():
    """A 1×1 DeviceMesh over a one-rank gloo group of this process, torn
    down after the test (no other test sees the group)."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield M.device_mesh(M.MeshSpec(("data", "model"), (1, 1)), "cpu")
    finally:
        dist.destroy_process_group()


def _numpy_args(args, draw):
    """Seeded numpy leaves in JAX's flattening order for ``args`` (a JAX
    tree of ShapeDtypeStructs), and each leaf's ``(arg index, path inside
    it)``; ``draw(arg index, path, sds)``."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(args)
    leaves, where = [], []
    for p, sds in flat:
        arg, _, rest = _path_str(p).partition("/")
        where.append((int(arg), rest))
        leaves.append(draw(int(arg), rest, sds))
    return leaves, where, treedef


def _flat_params(params) -> dict:
    return {"params/" + _path_str(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _run_both(jprog, prog, jax_params, leaves, where, treedef, dm):
    """JAX's ``jax.jit(prog.fn)`` and the port's step on the same leaves;
    the port's parameters carried across with ``interop.params_from_jax``."""
    from repro_torch.interop import params_from_jax

    tparams = params_from_jax(jax_params, device="cpu")
    tflat = dict(zip(("params/" + p for p in tree_paths(tparams)), tree_leaves(tparams)))
    jargs = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in leaves])
    jstate, jloss = jax.jit(jprog.fn)(*jargs)

    def local(spec, shape, i, high, path):
        arg, path = where[i]
        if arg == 0 and path in tflat:
            return tflat[path]
        return torch.from_numpy(np.array(leaves[i]))

    tstate, tloss = prog.fn(*specs.place_args(prog, dm, local))
    return (jstate, jloss), (tstate, tloss)


def _assert_state_close(tstate, jstate):
    from torch.distributed.tensor import DTensor

    flat, _ = jax.tree_util.tree_flatten_with_path(jstate)
    got = tree_leaves(tstate)
    assert len(got) == len(flat)
    for (path, want), t in zip(flat, got):
        t = t.full_tensor() if isinstance(t, DTensor) else t
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL, err_msg=_path_str(path))


@functools.lru_cache(maxsize=None)
def _small_stgnn():
    jarch = jax_get_arch("pgt-dcrnn-pems-all-la")
    jarch = dataclasses.replace(jarch, model=dataclasses.replace(jarch.model, num_nodes=12))
    arch = get_arch("pgt-dcrnn-pems-all-la")
    arch = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_nodes=12))
    params = jax.device_get(jpgt.init(jax.random.PRNGKey(0), jarch.model))
    return jarch, arch, params


@pytest.mark.parametrize("placement", ["replicated", "partitioned", "ondemand"])
def test_stgnn_cell_step_matches_jax(one_rank, placement):
    jarch, arch, params = _small_stgnn()
    jmesh = _jax_mesh(M.MeshSpec(("data", "model"), (1, 1)))
    jprog = jspecs.build_stgnn_train(jarch, jarch.shapes[0], jmesh, series_len=200,
                                     placement=placement)
    prog = specs.build_stgnn_train(arch, arch.shapes[0], M.MeshSpec(("data", "model"), (1, 1)),
                                   series_len=200, placement=placement)
    rng = np.random.default_rng(0)
    pflat = _flat_params(params)

    def draw(arg, path, sds):
        if path in pflat:  # the JAX init's parameters
            return pflat[path]
        if path.startswith("opt/"):  # a fresh optimizer
            return np.zeros(sds.shape, sds.dtype)
        if sds.dtype == jnp.int32:  # window starts in range
            return rng.integers(0, 150, size=sds.shape).astype(np.int32)
        return (rng.standard_normal(sds.shape) * 0.1).astype(np.float32)

    leaves, where, treedef = _numpy_args(jprog.args, draw)
    (jstate, jloss), (tstate, tloss) = _run_both(jprog, prog, params, leaves, where,
                                                 treedef, one_rank)
    np.testing.assert_allclose(float(tloss.full_tensor()), float(jloss), atol=ATOL, rtol=RTOL)
    _assert_state_close(tstate, jstate)


def test_lm_train_cell_step_matches_jax(one_rank):
    arch_id = "qwen1.5-4b"
    jarch = jax_get_arch(arch_id)
    jarch = dataclasses.replace(jarch, lm=jarch.smoke_config())
    arch = get_arch(arch_id)
    arch = dataclasses.replace(arch, lm=arch.smoke_config())
    one = M.MeshSpec(("data", "model"), (1, 1))
    jprog = jspecs.build_lm_train(jarch, JaxShapeCell("t", "train", 16, 4), _jax_mesh(one))
    prog = specs.build_lm_train(arch, ShapeCell("t", "train", 16, 4), one)
    assert prog.meta == jprog.meta and prog.meta["microbatches"] == 4
    params = jax.device_get(jlm.init(jax.random.PRNGKey(1), jarch.lm))
    pflat = _flat_params(params)
    rng = np.random.default_rng(1)

    def draw(arg, path, sds):
        if arg == 0:  # the JAX init's parameters, a fresh optimizer
            return pflat[path] if path in pflat else np.zeros(sds.shape, sds.dtype)
        if arg == 1:  # the token stream
            return rng.integers(0, jarch.lm.vocab, size=sds.shape).astype(np.int32)
        return rng.integers(0, specs.STREAM_LEN - 17, size=sds.shape).astype(np.int32)

    leaves, where, treedef = _numpy_args(jprog.args, draw)
    (jstate, jloss), (tstate, tloss) = _run_both(jprog, prog, params, leaves, where,
                                                 treedef, one_rank)
    np.testing.assert_allclose(float(tloss.full_tensor()), float(jloss), atol=ATOL, rtol=RTOL)
    _assert_state_close(tstate, jstate)
