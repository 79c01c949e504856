"""Serving over a (data × model) mesh: the port's sharded ``ServeEngine``
against the JAX package's single-device ``Server``, the counterpart of
``tests/test_serve.py``'s sharded pool test.

Four ranks (``tests/serve_mesh_ranks.py``), spawned once for the module,
form a gloo group on the CPU and a (data=2, model=2) mesh.  On the smoke
configs of qwen1.5-4b, recurrentgemma-2b (its RG-LRU through
``linear_scan(use_pallas=True)`` on local shards, the plain scan on CPU
tensors) and deepseek-v2-lite-16b (MLA, MoE), on seeded numpy weights
that both packages take (the ranks through ``params_from_jax``), each rank
serves six requests (greedy and sampled,
temperature 0.7, top-k 20, top-p 0.9) through contiguous and paged planes
(block 5, which does not divide ``max_len`` 48, and 16), with 8 slots (lane
rows over data) and 3 (whole on every rank).  Every rank's tokens must
equal the JAX ``Server``'s, run here in float32 on the same weights (the JAX
scan through its Pallas kernel in interpret mode, a float32 carry as the
port's); the cache must be laid out by ``cache_shardings`` /
``paged_cache_shardings`` with split leaves, the paged pool padded to a
data multiple as JAX's is, and a decode step must pull once on every rank.
The ranks also hold the local forms of attention, the ring write, the WKV
scan and the scan kernel's wrapper to the plain functions, and ranks 0 and
1 run the serving launcher as a group of two.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

import serve_mesh_ranks as ranks
from lm_parity import as_jax_dict
from repro.configs import get_arch as jax_get_arch
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.configs import get_arch
from repro_torch.models.lm import model as tm
from repro_torch.tree import tree_map

WORLD = 4
ARCHS = ("qwen1.5-4b", "recurrentgemma-2b", "deepseek-v2-lite-16b")


def _weights(arch: str):
    """(JAX config, seeded numpy weights): the port's ``init`` at seed 0 on
    the smoke config (equal to the JAX package's as a dict, recurrentgemma-
    2b's scan through its kernel), as numpy arrays that both packages take:
    the JAX ``Server`` as they are, the ranks through ``params_from_jax``."""
    over = {"use_pallas_scan": True} if arch == "recurrentgemma-2b" else {}
    jcfg = dataclasses.replace(jax_get_arch(arch).smoke_config(), **over)
    tcfg = dataclasses.replace(get_arch(arch).smoke_config(), **over)
    assert dataclasses.asdict(jcfg) == as_jax_dict(tcfg)
    tparams = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    return jcfg, tree_map(lambda t: t.numpy(), tparams)


def _jax_tokens(jcfg, jparams, arch: str) -> list[list[int]]:
    """The JAX reference Server's tokens for the ranks' requests."""
    srv = JaxServer(jparams, jcfg, JaxServeConfig(slots=2, max_len=ranks.MAX_LEN,
                                                  max_new_tokens=ranks.NEW_TOKENS))
    rids = [srv.submit(p, **kw) for p, kw in ranks.requests(arch)]
    out = srv.run()
    return [list(map(int, out[r])) for r in rids]


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """(each rank's results, the JAX Server's tokens by arch): the ranks
    run while the JAX references are made."""
    work = tmp_path_factory.mktemp("serve_mesh")
    weights = {a: _weights(a) for a in ARCHS}
    ctx = mp.spawn(ranks.run_rank, args=(WORLD, ranks.free_port(), ranks.free_port(),
                                         str(work), {a: w for a, (_, w) in weights.items()}),
                   nprocs=WORLD, join=False)
    want = {a: _jax_tokens(jcfg, jax.tree.map(jnp.asarray, w), a)
            for a, (jcfg, w) in weights.items()}
    while not ctx.join(timeout=300):
        pass
    got = [json.loads((work / f"rank{r}.json").read_text()) for r in range(WORLD)]
    return got, want


CASE_IDS = [f"{a}-slots{s}-{'paged' + str(b) if b else 'contiguous'}"
            for a, s, b in ranks.CASES]


@pytest.mark.parametrize("case", range(len(ranks.CASES)), ids=CASE_IDS)
def test_sharded_engine_serves_the_jax_servers_tokens(mesh_runs, case):
    got, want = mesh_runs
    arch, slots, bs = ranks.CASES[case]
    for rank in got:
        res = rank["serve"][case]
        assert (res["arch"], res["slots"], res["block_size"]) == (arch, slots, bs)
        assert res["tokens"] == want[arch]
        assert all(len(t) == ranks.NEW_TOKENS for t in res["tokens"])


@pytest.mark.parametrize("case", range(len(ranks.CASES)), ids=CASE_IDS)
def test_sharded_cache_layout_and_one_pull_a_step(mesh_runs, case):
    got, _ = mesh_runs
    arch, slots, bs = ranks.CASES[case]
    for rank in got:
        res = rank["serve"][case]
        assert res["mesh"] == {"data": 2, "model": 2} and res["dp"] == 2
        # every leaf placed as the rules say, and some leaves split
        assert res["placements_equal"]
        assert 0 < res["split_leaves"] <= res["leaves"]
        assert res["lanes_split"] == (slots % 2 == 0)
        # the global pool, not a rank's shard
        assert res["cache_bytes"] == res["cache_bytes_whole"]
        assert res["occupancy_after"] == 0.0
        # one device->host pull a decode step and a prefill group, on every rank
        assert res["decode_steps"] > 0
        assert res["pulls"] == res["decode_steps"] + res["prefill_groups"]
        if bs:
            # the JAX plane's device pool: null block + usable, padded to a
            # multiple of the data extent (src/repro/serve/plane.py:288-289)
            usable = res["pool_blocks"]
            assert res["n_dev"] == -(-(1 + usable) // 2) * 2
            assert usable == slots * -(-ranks.MAX_LEN // bs)


LOCAL_FORMS = ("attention_full", "attention_blockwise", "attention_banded", "attention_mqa",
               "decode_seq", "decode_seq_window", "decode_heads", "ring_11", "ring_6",
               "write_prefix", "wkv_out", "wkv_state", "scan_seq", "scan_last")
# float32: the local forms run the same ops on each rank's rows and heads;
# the split softmax sums the sequence in two parts
LOCAL_ATOL = {"decode_seq": 1e-6, "decode_seq_window": 1e-6}


@pytest.mark.parametrize("name", LOCAL_FORMS)
def test_local_forms_equal_the_whole_tensor_functions(mesh_runs, name):
    got, _ = mesh_runs
    for rank in got:
        assert rank["local_forms"][name] <= LOCAL_ATOL.get(name, 0.0), name


def test_scan_on_shards_keeps_the_placements_and_refuses_a_split_sequence(mesh_runs):
    got, _ = mesh_runs
    for rank in got:
        lf = rank["local_forms"]
        assert lf["scan_placements"] == [["Shard", 0], ["Shard", 2]]
        assert "sequence dim is split" in lf["scan_split_sequence"]


def test_launcher_under_two_ranks_prints_the_jax_launchers_mesh_field(mesh_runs):
    """Under two ranks rank 0 prints the report with ``mesh=`` as the JAX
    launcher prints it (``dict(zip(mesh.axis_names, mesh.devices.shape))``
    of its host mesh; here data over both ranks) and the tokens the port's
    one-device launcher prints (held to the JAX launcher's in
    tests/test_torch_serve_launcher.py); rank 1 prints no report."""
    from repro.launch.mesh import make_host_mesh

    got, _ = mesh_runs
    ours, single, other = got[0]["launcher"], got[0]["launcher_single"], got[1]["launcher"]
    jmesh = make_host_mesh()
    assert f"mesh={dict(zip(jmesh.axis_names, jmesh.devices.shape))}" in single
    assert "mesh={'data': 2, 'model': 1}" in ours
    lines = lambda text: [ln.strip() for ln in text.splitlines()
                          if ln.strip().startswith(("served", "req "))]
    assert lines(ours)[0].startswith("served 5/5 requests")
    assert lines(ours)[1:] == lines(single)[1:] and len(lines(ours)) == 6
    assert lines(other) == []


def test_roll_seq_and_write_prefix_are_the_plain_ops_bit_for_bit():
    """On plain tensors the ring write's ``cat`` is ``torch.roll`` and the
    prefix write is the slice assignment they replace."""
    from repro_torch.models.lm.attention import roll_seq, write_prefix

    x = torch.randn(3, 7, 2, 4, generator=torch.Generator().manual_seed(0))
    for shift in range(-8, 15):
        assert torch.equal(roll_seq(x, shift), torch.roll(x, shift, dims=1))
    cache = torch.zeros(3, 9, 2, 4, dtype=torch.bfloat16)
    want = cache.clone()
    write_prefix(cache, x[:, :5])
    want[:, :5] = x[:, :5].to(torch.bfloat16)
    assert torch.equal(cache, want)


def test_rg_lru_scans_ran_on_local_shards(mesh_runs):
    """recurrentgemma-2b's RG-LRU went through ``linear_scan(use_pallas=
    True)`` on DTensor operands (its shard route) in every prefill and
    decode step; no other arch's case scans."""
    got, _ = mesh_runs
    for rank in got:
        for res in rank["serve"]:
            if res["arch"] == "recurrentgemma-2b":
                # 3 rec layers of the smoke config's 4, in each step
                assert res["scans_on_shards"] == 3 * (res["decode_steps"]
                                                      + res["prefill_groups"])
            else:
                assert res["scans_on_shards"] == 0
