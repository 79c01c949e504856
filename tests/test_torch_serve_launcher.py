"""The port's serving launcher (``repro_torch.launch.serve``) against the JAX
package's (``repro.launch.serve``), on the CPU.

- The port takes every flag of the JAX launcher, plus ``--device``,
  ``--smoke`` and ``--prompt-lens``.
- With the JAX draw of the smoke config's weights bridged into the port's
  ``init``, the engine role prints the JAX launcher's per-request lines (the
  first 8 tokens of each request): greedy contiguous, and paged with sampled
  and filtered lanes over 2 planes, and the Poisson trace.
- The fleet role spawns its workers as processes (``--role worker``, file
  mailboxes and heartbeats under ``--fleet-dir``) and serves exactly the
  engine role's tokens at temperature 0.8.
"""
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_launcher
from repro.configs import get_arch as jax_get_arch
from repro.models.lm import model as jm
from repro_torch.interop import params_from_jax
from repro_torch.launch import serve as launcher
from repro_torch.models.lm import model as tm

ROOT = Path(__file__).resolve().parents[1]
PORT_ONLY = {"--device", "--smoke", "--prompt-lens"}


def _flags(parser) -> set[str]:
    return {s for a in parser._actions for s in a.option_strings if s.startswith("--")}


def test_flags_cover_the_jax_launcher():
    jax_flags = set(re.findall(r'add_argument\("(--[a-z-]+)"',
                               (ROOT / "src/repro/launch/serve.py").read_text()))
    assert "--pool-blocks" in jax_flags and len(jax_flags) == 21
    assert _flags(launcher._parser()) - {"--help"} == jax_flags | PORT_ONLY


def _req_lines(text: str) -> list[str]:
    return [ln.strip() for ln in text.splitlines() if ln.strip().startswith("req ")]


@pytest.mark.parametrize("flags", [
    ["--requests", "6", "--slots", "4"],
    ["--requests", "7", "--slots", "2", "--planes", "2", "--block-size", "5",
     "--pool-blocks", "12", "--temperature", "0.7", "--top-k", "20", "--top-p", "0.9",
     "--sample-seed", "9", "--max-new-tokens", "10"],
    ["--requests", "5", "--slots", "2", "--trace", "poisson", "--rate", "500",
     "--temperature", "1.1", "--seed", "3"],
], ids=["greedy", "paged-sampled-2-planes", "poisson"])
def test_engine_role_serves_the_jax_launchers_tokens(flags, monkeypatch, capsys):
    seed = int(flags[flags.index("--seed") + 1]) if "--seed" in flags else 0
    jparams = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                     jax_get_arch("qwen1.5-4b").smoke_config()))
    monkeypatch.setattr(tm, "init", lambda gen, cfg, device: params_from_jax(
        jparams, device=device))
    monkeypatch.setattr(sys, "argv", ["serve", *flags])
    jax_launcher.main()
    theirs = _req_lines(capsys.readouterr().out)
    res = launcher.main([*flags, "--smoke", "--device", "cpu"])
    ours = _req_lines(capsys.readouterr().out)
    n = int(flags[flags.index("--requests") + 1])
    assert len(ours) == n and ours == theirs
    assert all(r.status == "ok" for r in res["engine"].router.done.values())
    if "--block-size" in flags:
        planes = res["engine"].planes
        assert len(planes) == 2 and all(p.pool.num_blocks == 12 for p in planes)


def test_fleet_role_serves_the_engine_roles_tokens(tmp_path, capsys):
    """Two worker processes on the CPU (each draws the same weights from
    ``--seed``), coordinated over file mailboxes: the same tokens as one
    in-process engine, and both workers served."""
    flags = ["--smoke", "--device", "cpu", "--requests", "6", "--slots", "2",
             "--temperature", "0.8", "--sample-seed", "4", "--max-new-tokens", "6"]
    want = launcher.main(flags)["results"]
    res = launcher.main([*flags, "--role", "fleet", "--planes", "2",
                         "--fleet-dir", str(tmp_path / "fleet"), "--hb-timeout", "60"])
    assert res["results"] == want
    assert res["exit_codes"] == [0, 0] and not res["dead_at"]
    assert all(w.served > 0 for w in res["fleet"].workers.values())
    for wid in (0, 1):
        assert (tmp_path / "fleet" / f"w{wid}_a0" / "pid").read_text().isdigit()
        assert (tmp_path / "fleet" / "hb" / f"hb_{wid}.json").exists()
    assert "served 6/6 requests" in capsys.readouterr().out


def test_worker_role_needs_a_fleet_dir_and_cuda_is_the_default(monkeypatch):
    with pytest.raises(SystemExit, match="fleet-dir"):
        launcher.main(["--role", "worker", "--smoke", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--smoke"])


def test_dtype_and_prompt_lens():
    """The weights are drawn straight into the config's compute dtype (the
    smoke config's float32), and the prompts take the given lengths."""
    res = launcher.main(["--smoke", "--device", "cpu", "--arch", "recurrentgemma-2b",
                         "--requests", "4", "--slots", "2", "--max-len", "64",
                         "--prompt-lens", "16,32", "--max-new-tokens", "3"])
    eng = res["engine"]
    assert eng.planes[0].cfg.dtype == "float32"
    assert eng.planes[0].params["embed"].dtype == torch.float32
    assert all(len(r.out) == 3 for r in eng.router.done.values())
    rng = np.random.default_rng(0)
    assert [r.prompt.size for r in sorted(eng.router.done.values(), key=lambda r: r.rid)] \
        == list(rng.choice([16, 32], size=4))
