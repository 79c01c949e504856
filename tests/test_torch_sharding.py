"""The port's meshes and sharding rules against the JAX package's.

Every rule is a pure function of a leaf's path and shape, the config and the
mesh's axis sizes, so both packages run here with no devices: JAX on a mesh
of its one CPU device tiled to 256 or 512 slots, the port on a ``MeshSpec``.
"""
import functools

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.configs import LM_ARCHS as JAX_LM_ARCHS
from repro.configs import get_arch as jax_get_arch
from repro.core import distributed as jdist
from repro.launch import sharding as jshd
from repro.models.lm import model as jlm
from repro_torch.configs import get_arch
from repro_torch.core import distributed as tdist
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding as shd
from repro_torch.launch.specs import _cache_shape, _lm_params_shape
from repro_torch.models.lm import model as tlm
from repro_torch.tree import tree_leaves, tree_paths

ARCHS = sorted(JAX_LM_ARCHS)
MESHES = {"16x16": False, "2x16x16": True}


def _jax_mesh(spec: M.MeshSpec) -> Mesh:
    n = M.mesh_chips(spec)
    return Mesh(np.array(jax.devices() * n)[:n].reshape(spec.sizes), spec.axis_names)


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch_id):
    cfg = jax_get_arch(arch_id).lm
    return jax.eval_shape(lambda: jlm.init(jax.random.PRNGKey(0), cfg))


@functools.lru_cache(maxsize=None)
def _port_params_shape(arch_id):
    return _lm_params_shape(get_arch(arch_id).lm)


def _jax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jshd._path_str(p), tuple(s.spec)) for p, s in flat]


def _port_specs(tree):
    return list(zip(tree_paths(tree), [tuple(s.spec) for s in tree_leaves(tree)]))


def test_production_meshes_and_axes():
    for mp, want in ((False, ((16, 16), ("data", "model"))),
                     (True, ((2, 16, 16), ("pod", "data", "model")))):
        spec = M.make_production_mesh(multi_pod=mp)
        assert (spec.sizes, spec.axis_names) == want
        jmesh = _jax_mesh(spec)
        assert M.mesh_chips(spec) == int(np.prod(jmesh.devices.shape))
        assert spec.shape == dict(jmesh.shape)
        assert M.dp_size(spec) == (512 if mp else 256) // 16
        assert M.tp_size(spec) == 16
        assert M.dp_axes(spec) == tuple(a for a in jmesh.axis_names if a in ("pod", "data"))
    host = M.make_host_mesh(model=2, devices=8)
    assert host.shape == {"data": 4, "model": 2}
    assert M.shrink_mesh(host, 2).shape == {"data": 2, "model": 2}
    assert M.shrink_mesh(host, 8) is host
    with pytest.raises(ValueError):
        M.make_host_mesh(model=3, devices=8)


@pytest.mark.parametrize("mode", ["fsdp", "pure_dp", "no_tp"])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_param_specs_equal_jax(arch_id, mesh_name, mode):
    spec = M.make_production_mesh(multi_pod=MESHES[mesh_name])
    # fsdp: the train cells' default; no_tp: their mode2d (FSDP over every axis)
    kw = {"fsdp": {}, "pure_dp": {"pure_dp": True},
          "no_tp": {"tp_rules": False, "fsdp": spec.axis_names}}[mode]
    want = _jax_specs(jshd.lm_param_shardings(
        _jax_params_shape(arch_id), jax_get_arch(arch_id).lm, _jax_mesh(spec), **kw))
    got = _port_specs(shd.lm_param_shardings(
        _port_params_shape(arch_id), get_arch(arch_id).lm, spec, **kw))
    assert got == want


@pytest.mark.parametrize("arch_id", ARCHS)
def test_cache_shardings_equal_jax(arch_id):
    spec = M.make_production_mesh()
    jmesh = _jax_mesh(spec)
    jcfg = jax_get_arch(arch_id).smoke_config()
    cfg = get_arch(arch_id).smoke_config()
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 32, 64))
    assert _port_specs(shd.cache_shardings(_cache_shape(cfg, 32, 64), cfg, spec)) == \
        _jax_specs(jshd.cache_shardings(jcache, jcfg, jmesh))
    jpaged = jax.eval_shape(lambda: jlm.init_paged_cache(jcfg, 32, 64, num_blocks=48,
                                                         block_size=8))
    from repro_torch.launch.specs import _shapes
    paged = _shapes(lambda: tlm.init_paged_cache(cfg, 32, 64, num_blocks=48, block_size=8,
                                                 device="cpu"))
    assert _port_specs(shd.paged_cache_shardings(paged, cfg, spec, tlm.paged_cache_mask(cfg))) == \
        _jax_specs(jshd.paged_cache_shardings(jpaged, jcfg, jmesh, jlm.paged_cache_mask(jcfg)))


@pytest.mark.parametrize("mp", [False, True])
def test_activation_and_stgnn_specs_equal_jax(mp):
    spec = M.make_production_mesh(multi_pod=mp)
    jmesh = _jax_mesh(spec)
    for pure in (False, True):
        assert tuple(shd.batch_spec(spec, pure_dp=pure)) == tuple(jshd.batch_spec(jmesh, pure_dp=pure))
        assert tuple(shd.batch_sharding(spec, pure_dp=pure).spec) == \
            tuple(jshd.batch_sharding(jmesh, pure_dp=pure).spec)
    for part in (False, True):
        assert tuple(shd.series_sharding(spec, partitioned=part).spec) == \
            tuple(jshd.series_sharding(jmesh, partitioned=part).spec)
    assert tuple(shd.replicated(spec).spec) == tuple(jshd.replicated(jmesh).spec) == ()
    st = shd.state_shardings({"w": shd.replicated(spec)}, spec)
    assert tuple(st["opt"]["step"].spec) == () and st["opt"]["m"]["w"] is st["params"]["w"]


@pytest.mark.parametrize("mp", [False, True])
def test_core_distributed_helpers_equal_jax(mp):
    spec = M.make_production_mesh(multi_pod=mp)
    jmesh = _jax_mesh(spec)
    assert tdist.data_axes(spec) == jdist.data_axes(jmesh)
    for tp, jp in zip(tdist.Placement, jdist.Placement):
        assert tp.value == jp.value
        assert tuple(tdist.series_sharding(spec, tp).spec) == \
            tuple(jdist.series_sharding(jmesh, jp).spec)
    for pure in (False, True):
        assert tuple(tdist.batch_sharding(spec, pure_dp=pure).spec) == \
            tuple(jdist.batch_sharding(jmesh, pure_dp=pure).spec)


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mp = M.make_production_mesh(multi_pod=True)
    assert shd.to_placements(shd.P(("pod", "data")), mp) == (Shard(0), Shard(0), Replicate())
    assert shd.to_placements(shd.P(None, "data", "model"), mp) == \
        (Replicate(), Shard(1), Shard(2))
    assert shd.to_placements(shd.P(), mp) == (Replicate(),) * 3
    # an axis of one slot holds the whole dim
    one = M.MeshSpec(("data", "model"), (8, 1))
    assert shd.to_placements(shd.P(("data", "model")), one) == (Shard(0), Replicate())
    with pytest.raises(ValueError):
        shd.to_placements(shd.P(("data", "pod")), mp)
    with pytest.raises(ValueError):
        shd.to_placements(shd.P("data", "data"), mp)


# ------------------------------------------- the JAX package's rule tests
def test_lm_param_specs_tp_divisibility():
    """Rules must only shard dims that divide the axis; fall back otherwise."""
    cfg = get_arch("minitron-8b").lm  # heads 32, kv 8, d_ff 16384
    mesh16 = M.MeshSpec(("data", "model"), (1, 16))
    spec = shd.lm_param_spec("stages/0/sub0/attn/wq/w", (32, 4096, 4096), cfg, mesh16)
    assert spec[-1] == "model"  # heads 32 % 16 == 0 -> column parallel
    spec_kv = shd.lm_param_spec("stages/0/sub0/attn/wk/w", (32, 4096, 1024), cfg, mesh16)
    assert spec_kv[-1] is None  # kv heads 8 % 16 != 0 -> replicated on model
    qwen = get_arch("qwen1.5-4b").lm  # heads 20 -> not divisible
    spec_q = shd.lm_param_spec("stages/0/sub0/attn/wq/w", (40, 2560, 2560), qwen, mesh16)
    assert "model" not in tuple(spec_q)


def test_lm_head_vocab_sharded():
    cfg = get_arch("qwen1.5-4b").lm
    mesh16 = M.MeshSpec(("data", "model"), (1, 16))
    assert shd.lm_param_spec("lm_head/w", (2560, 151936), cfg, mesh16)[-1] == "model"


def test_fsdp_respects_divisibility_and_size():
    cfg = get_arch("qwen1.5-4b").lm
    mesh = M.MeshSpec(("data", "model"), (4, 4))
    # tiny leaf (< min_size elements): no FSDP
    assert tuple(shd.lm_param_spec("stages/0/sub0/norm1", (40, 64), cfg, mesh)) == (None, None)
    # large leaf: largest divisible dim gets "data"
    assert "data" in tuple(shd.lm_param_spec("stages/0/sub0/mlp/wi/w", (40, 2560, 6912),
                                             cfg, mesh))
