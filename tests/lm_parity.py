"""Shared checks of the port's LM archs against the JAX package (imported by
tests/test_torch_{moe,mla,rwkv6,lm_archs}.py; not a test module itself).

Each arch runs at its smoke config in float32, with the JAX package's
parameters bridged into the port (``params_from_jax``) and the same seeded
numpy tokens fed to both.  Logits, the auxiliary loss, ``loss_fn`` and
every gradient leaf (against ``jax.value_and_grad``) are held within atol
1e-5 plus rtol 1e-4 of the reference (unless a caller states another atol),
as are ``prefill`` and four ``decode_step``s after it, and the caches they
leave.

``launcher_history_matches_jax`` runs ``repro_torch.launch.train.main`` and
the JAX launcher with ``--smoke`` on the same flags and parameters and holds
the histories within atol 1e-5 plus rtol 1e-4 (losses, gradient norms,
learning rates, ``val_loss``, ``val_ppl``), at lr 1e-4.  At 1e-3 the rwkv6
smoke model's gradient norm reaches 117 by step 11, and float32 rounding
differences between the two frameworks (2e-6 relative in the first step's
gradient norm) grow to 3e-3 in the loss by step 18; at 1e-4 every history
agrees to 1e-6.
"""
from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_launcher
from repro.configs import get_arch as jax_get_arch
from repro.models.lm import model as jm
from repro_torch.configs import get_arch
from repro_torch.interop import params_from_jax
from repro_torch.launch.train import main
from repro_torch.models.lm import model as tm
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

ATOL, RTOL = 1e-5, 1e-4
LAUNCH = ["--smoke", "--entries", "120", "--seq-len", "16", "--batch", "4",
          "--seed", "0", "--lr", "1e-4"]


def t_(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def jax_paths(tree) -> list[str]:
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


#: The port's own config fields (DeepSeek-V2's routing and YaRN, which the
#: JAX package lacks), with the defaults that keep the JAX package's
#: behaviour.
PORT_ONLY_FIELDS = {"rope_scaling": None, "norm_topk_prob": True,
                    "routed_scaling_factor": 1.0, "seq_aux": False, "dropless": False}


def as_jax_dict(cfg) -> dict:
    """``dataclasses.asdict`` of a port ``LMConfig`` or ``MoEConfig``
    without the port's own fields, each asserted at its default: the dict
    the JAX package's config of the same arch gives."""
    out = dataclasses.asdict(cfg)
    for node in (out, out.get("moe") or {}):
        for name, default in PORT_ONLY_FIELDS.items():
            if name in node:
                assert node.pop(name) == default, name
    return out


def bridge(arch_id: str, seed: int = 0, **overrides):
    """(jcfg, tcfg, jparams, tparams): the arch's smoke config in both
    packages (equal as dicts) and the JAX draws bridged into the port."""
    jcfg = dataclasses.replace(jax_get_arch(arch_id).smoke_config(), **overrides)
    tcfg = dataclasses.replace(get_arch(arch_id).smoke_config(), **overrides)
    assert dataclasses.asdict(jcfg) == as_jax_dict(tcfg)
    jparams = jax.jit(jm.init, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), device="cpu")


def check_init_tree(arch_id: str, **overrides):
    """The port's ``init`` gives the JAX tree: paths, shapes and dtypes."""
    jcfg, tcfg, jparams, _ = bridge(arch_id, **overrides)
    ours = tm.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert tree_paths(ours) == jax_paths(jparams)
    for t, j in zip(tree_leaves(ours), jax.tree.leaves(jparams)):
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(str(j.dtype))
        assert torch.isfinite(t.float()).all()


def check_forward_loss_and_grads(arch_id: str, *, seq: int = 12, prefix: int = 0,
                                 atol: float = ATOL):
    """``forward`` (logits, aux), ``loss_fn`` and every gradient leaf; with
    ``prefix`` patch embeddings prepended (the loss slices them off)."""
    jcfg, tcfg, jparams, tparams = bridge(arch_id)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, tcfg.vocab, (2, seq)).astype(np.int32)
    labels = rng.integers(-1, tcfg.vocab, (2, seq)).astype(np.int32)  # -1: ignored
    pe = (rng.standard_normal((2, prefix, tcfg.d_model)).astype(np.float32)
          if prefix else None)
    jpe = None if pe is None else jnp.asarray(pe)
    tpe = None if pe is None else t_(pe)

    jl, jaux = jm.forward(jparams, jcfg, jnp.asarray(toks), prefix_embeds=jpe)
    tl, taux = tm.forward(tparams, tcfg, t_(toks, torch.long), prefix_embeds=tpe)
    assert tl.shape == (2, seq + prefix, tcfg.padded_vocab)
    close(tl, jl, atol=atol, err_msg="logits")
    close(taux, jaux, atol=atol, err_msg="aux")

    def jloss(p):
        return jm.loss_fn(p, jcfg, jnp.asarray(toks), jnp.asarray(labels),
                          prefix_embeds=jpe)

    (jv, jmet), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(tparams)]
    tv, tmet = tm.loss_fn(tree_unflatten(tparams, leaves), tcfg, t_(toks, torch.long),
                          t_(labels, torch.long), prefix_embeds=tpe)
    grads = torch.autograd.grad(tv, leaves, allow_unused=True, materialize_grads=True)
    close(tv, jv, atol=atol, err_msg="loss")
    assert sorted(tmet) == sorted(jmet) == ["aux", "nll"]
    for k in tmet:
        close(tmet[k], jmet[k], atol=atol, err_msg=k)
    for path, g, j in zip(tree_paths(tparams), grads, jax.tree.leaves(jgrads)):
        close(g, j, atol=atol, err_msg=path)


def check_prefill_and_decode(arch_id: str, *, prompt: int = 8, steps: int = 4,
                             prefix: int = 0, atol: float = ATOL):
    """``prefill`` of a ``prompt``-token batch, then ``steps`` decode steps:
    every step's logits, and the caches at the end, agree with JAX's."""
    jcfg, tcfg, jparams, tparams = bridge(arch_id)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, tcfg.vocab, (2, prompt + steps)).astype(np.int32)
    pe = (rng.standard_normal((2, prefix, tcfg.d_model)).astype(np.float32)
          if prefix else None)
    max_len = prefix + prompt + steps + 4
    jc, tc = jm.init_cache(jcfg, 2, max_len), tm.init_cache(tcfg, 2, max_len, device="cpu")
    assert tree_paths(tc) == jax_paths(jc)
    jlog, jc, jlen = jm.prefill(jparams, jcfg, jnp.asarray(toks[:, :prompt]), jc,
                                prefix_embeds=None if pe is None else jnp.asarray(pe))
    tlog, tc, tlen = tm.prefill(tparams, tcfg, t_(toks[:, :prompt], torch.long), tc,
                                prefix_embeds=None if pe is None else t_(pe))
    close(tlog, jlog, atol=atol, err_msg="prefill")
    assert tlen.tolist() == np.asarray(jlen).tolist()
    jdecode = jax.jit(lambda p, t, c, n: jm.decode_step(p, jcfg, t, c, n))
    for i in range(prompt, prompt + steps):
        tok = toks[:, i:i + 1]
        jlog, jc = jdecode(jparams, jnp.asarray(tok), jc, jlen)
        tlog, tc = tm.decode_step(tparams, tcfg, t_(tok, torch.long), tc, tlen)
        close(tlog, jlog, atol=atol, err_msg=f"decode step {i}")
        jlen, tlen = jlen + 1, tlen + 1
    for path, ours, theirs in zip(tree_paths(tc), tree_leaves(tc), jax.tree.leaves(jc)):
        close(ours, theirs, atol=atol, err_msg=path)


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _bridge_init(monkeypatch, arch_id):
    """The port's launcher draws its parameters from the JAX package's
    ``init`` at the same seed, so both launchers train the same model."""
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                     jax_get_arch(arch_id).smoke_config()))
    monkeypatch.setattr(tm, "init", lambda gen, cfg, device: params_from_jax(
        jparams, device=device))


def launcher_history_matches_jax(tmp_path, monkeypatch, arch_id, shuffle):
    _bridge_init(monkeypatch, arch_id)
    flags = ["--arch", arch_id, *LAUNCH, "--shuffle", shuffle]
    _, history = main([*flags, "--device", "cpu", "--history-out", str(tmp_path / "t.jsonl")])
    monkeypatch.setattr(sys, "argv", ["train", *flags,
                                      "--history-out", str(tmp_path / "j.jsonl")])
    jax_launcher.main()
    ours, theirs = _rows(tmp_path / "t.jsonl"), _rows(tmp_path / "j.jsonl")
    assert [sorted(r) for r in ours] == [sorted(r) for r in theirs]
    assert [r["step"] for r in ours] == [10, 18]  # log_every 10, then the epoch row
    assert "val_ppl" in ours[-1]
    for key in ("loss", "nll", "aux", "grad_norm", "lr", "val_loss", "val_ppl"):
        got = [r[key] for r in ours if key in r]
        want = [r[key] for r in theirs if key in r]
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=key)
    assert history[-1]["val_ppl"] == pytest.approx(np.exp(history[-1]["val_loss"]))
