"""Port parity for the elastic serving fleet (``serve/fleet.py``): the
cases of tests/test_serve_fleet.py on the port's workers and coordinator, in
process through ``LocalMailbox`` (``FileMailbox`` for the spool cases), on
qwen1.5-4b's smoke config bridged from the reference's ``lm_setup``.

- mailbox spools deliver in order exactly once (both flavours), and the
  file spool stops at a gap;
- a 2-worker fleet's tokens equal the JAX ``Server``'s;
- kill drill: a dead worker's in-flight requests are re-prefilled on the
  survivor from prompt + generated prefix, and every request's tokens still
  equal the JAX ``Server``'s, greedy and at temperature 0.8;
- rejoin: a returned incarnation (bumped ``attempt``) is assigned new work;
  messages from the dead incarnation are dropped (no double finish);
- the coordinator mirrors block accounting (a never-fitting request is
  rejected at fleet submit), and deadlines cancel in-flight work;
- a restore's logits (a prefill of prompt + generated prefix) differ from
  the decode step's they replace by roundings alone, as the JAX package's
  do: float32 ulps, and in bf16 on recurrentgemma's smoke config up to a
  tenth, so that its argmax can move, in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lm_parity import bridge
from repro.models.lm import model as jm
from repro.serve import ServeConfig as JaxServeConfig
from repro.serve import Server as JaxServer
from repro_torch.models.lm import model as tm
from repro_torch.serve import (FileMailbox, FleetEngine, LocalMailbox, ServeConfig,
                               ServeWorker)


@pytest.fixture(scope="module")
def lm_setup():
    jcfg, tcfg, jparams, tparams = bridge("qwen1.5-4b", seed=1)
    return jcfg, tcfg, jparams, tparams


def _reference(lm_setup, sc: dict, prompts, **submit):
    """The JAX Server's tokens for ``prompts`` (``submit`` maps an index to
    a keyword value)."""
    jcfg, _, jparams, _ = lm_setup
    srv = JaxServer(jparams, jcfg, JaxServeConfig(**sc))
    for i, p in enumerate(prompts):
        srv.submit(p, **{k: f(i) for k, f in submit.items()})
    return srv.run()


def _prompts(n, rng, lo=2, hi=10):
    return [rng.integers(0, 120, size=int(rng.integers(lo, hi))) for _ in range(n)]


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _worker(lm_setup, sc, wid, inbox, outbox, **kw):
    _, tcfg, _, tparams = lm_setup
    return ServeWorker(tparams, tcfg, sc, worker_id=wid, inbox=inbox, outbox=outbox,
                       device="cpu", **kw)


def _build_fleet(lm_setup, sc, *, world=2, clock=None):
    fleet = FleetEngine(sc, world=world, hb_timeout=1.5,
                        clock=clock or _Clock())
    workers = {}
    for wid in range(world):
        inbox, outbox = LocalMailbox(), LocalMailbox()
        workers[wid] = _worker(lm_setup, sc, wid, inbox, outbox)
        fleet.attach(wid, send=inbox, recv=outbox)
    return fleet, workers


def _drive(fleet, workers, clock, *, skip=(), limit=600):
    """Tick coordinator + workers with fresh beats until the fleet drains."""
    n = 0
    while fleet.pending() or n == 0:
        fleet.tracker.observe({w.worker_id: n for w in workers.values()
                               if w.worker_id not in skip})
        fleet.tick()
        for w in workers.values():
            if w.worker_id not in skip:
                w.tick()
        clock.t += 0.01
        n += 1
        assert n < limit, "fleet made no progress"
    return fleet.results()


# ------------------------------------------------------------------ mailboxes
def test_local_mailbox_fifo_exactly_once():
    mb = LocalMailbox()
    for i in range(3):
        mb.send({"i": i})
    assert [m["i"] for m in mb.recv()] == [0, 1, 2]
    assert mb.recv() == []  # drained


def test_file_mailbox_ordered_and_gap_proof(tmp_path):
    mb = FileMailbox(str(tmp_path / "spool"))
    for i in range(5):
        mb.send({"i": i})
    reader = FileMailbox(str(tmp_path / "spool"))
    assert [m["i"] for m in reader.recv()] == [0, 1, 2, 3, 4]
    assert reader.recv() == []
    # a fresh writer over an existing spool continues the sequence
    mb2 = FileMailbox(str(tmp_path / "spool"))
    mb2.send({"i": 5})
    assert [m["i"] for m in reader.recv()] == [5]


def test_file_mailbox_reader_stops_at_gap(tmp_path):
    """A missing sequence number (message mid-write) delays delivery, never
    reorders: the reader stops at the gap and resumes once it fills."""
    import os
    d = str(tmp_path / "spool")
    mb = FileMailbox(d)
    mb.send({"i": 0})
    mb.send({"i": 1})
    os.rename(os.path.join(d, "m_00000001.json"),
              os.path.join(d, "hidden"))
    reader = FileMailbox(d)
    assert reader.recv() == []  # message 1 missing: nothing delivered yet
    os.rename(os.path.join(d, "hidden"),
              os.path.join(d, "m_00000001.json"))
    assert [m["i"] for m in reader.recv()] == [0, 1]


# ------------------------------------------------------------ fleet identity
def test_fleet_bit_identical_to_server(lm_setup):
    base = dict(slots=2, max_len=48, max_new_tokens=6, eos_id=7)
    sc = ServeConfig(**base)
    rng = np.random.default_rng(0)
    prompts = _prompts(6, rng)
    ref = _reference(lm_setup, base, prompts)

    clock = _Clock()
    fleet, workers = _build_fleet(lm_setup, sc, clock=clock)
    rids = [fleet.submit(p) for p in prompts]
    res = _drive(fleet, workers, clock)
    for i, rid in enumerate(rids):
        assert res[rid] == ref[i], f"request {i} diverged"
    # both workers actually served (the point of a fleet)
    assert all(w.served > 0 for w in fleet.workers.values())


def test_fleet_kill_restores_on_survivor_bit_identical(lm_setup):
    """THE elasticity contract: kill a worker mid-decode; its in-flight
    requests re-prefill on the survivor from prompt + generated prefix and
    every output stays bit-identical to the reference server."""
    sc = ServeConfig(slots=2, max_len=48, max_new_tokens=8, block_size=4)
    rng = np.random.default_rng(0)
    prompts = _prompts(6, rng)
    ref = _reference(lm_setup, dict(slots=2, max_len=48, max_new_tokens=8), prompts)

    clock = _Clock()
    fleet, workers = _build_fleet(lm_setup, sc, clock=clock)
    rids = [fleet.submit(p) for p in prompts]

    n, killed, saw_partial = 0, False, False
    while fleet.pending() or n == 0:
        beats = {0: n} if killed else {0: n, 1: n}
        fleet.tracker.observe(beats)
        fleet.tick()
        for wid, w in workers.items():
            if not (killed and wid == 1):
                w.tick()
        if not killed and n == 3:
            # kill mid-decode: worker 1 holds in-flight work with a partial
            # generated prefix (the restore path must CONTINUE, not restart)
            infl = fleet.workers[1].inflight
            saw_partial = any(0 < len(r.out) < r.budget
                              for r, _ in infl.values())
            assert infl, "worker 1 had nothing in flight at the kill point"
            killed = True
            clock.t += 2.0  # silence > hb_timeout: tracker flips it dead
        clock.t += 0.01
        n += 1
        assert n < 800, "fleet made no progress after the kill"

    assert saw_partial, "kill point missed the mid-decode window"
    res = fleet.results()
    for i, rid in enumerate(rids):
        assert res[rid] == ref[i], f"request {i} diverged after the kill"
    assert fleet.workers[1].served == 0  # everything landed on the survivor
    assert fleet.workers[0].served == len(prompts)


def test_fleet_kill_restores_sampled_bit_identical(lm_setup):
    """The PR-10 payoff: the same kill→re-prefill drill at temperature > 0.
    Keyed draws depend only on (seed, rid, position), so the survivor's
    re-prefill of prompt + g generated tokens samples at position plen + g —
    re-deriving exactly the draw the dead worker would have made next."""
    base = dict(slots=2, max_len=48, max_new_tokens=8)
    sc = ServeConfig(**base)
    rng = np.random.default_rng(0)
    prompts = _prompts(6, rng)
    ref = _reference(lm_setup, base, prompts, temperature=lambda i: 0.8,
                     seed=lambda i: 40 + i)

    clock = _Clock()
    fleet, workers = _build_fleet(lm_setup, sc, clock=clock)
    rids = [fleet.submit(p, temperature=0.8, seed=40 + i)
            for i, p in enumerate(prompts)]

    n, killed, saw_partial = 0, False, False
    while fleet.pending() or n == 0:
        beats = {0: n} if killed else {0: n, 1: n}
        fleet.tracker.observe(beats)
        fleet.tick()
        for wid, w in workers.items():
            if not (killed and wid == 1):
                w.tick()
        if not killed and n == 3:
            infl = fleet.workers[1].inflight
            saw_partial = any(0 < len(r.out) < r.budget
                              for r, _ in infl.values())
            assert infl, "worker 1 had nothing in flight at the kill point"
            killed = True
            clock.t += 2.0
        clock.t += 0.01
        n += 1
        assert n < 800, "fleet made no progress after the kill"

    assert saw_partial, "kill point missed the mid-decode window"
    res = fleet.results()
    for i, rid in enumerate(rids):
        assert res[rid] == ref[i], \
            f"sampled request {i} diverged after the kill"
    assert fleet.workers[0].served == len(prompts)


def test_fleet_rejoin_and_stale_incarnation_dropped(lm_setup):
    base = dict(slots=2, max_len=48, max_new_tokens=4)
    sc = ServeConfig(**base)
    rng = np.random.default_rng(2)
    prompts = _prompts(4, rng)
    ref = _reference(lm_setup, base, prompts)

    clock = _Clock()
    fleet, workers = _build_fleet(lm_setup, sc, clock=clock)
    # kill worker 1 before it ever beats, drain the first wave on worker 0
    clock.t += 2.0
    fleet.tracker.observe({0: 0})
    rids = [fleet.submit(p) for p in prompts[:2]]
    res = _drive(fleet, workers, clock, skip=(1,))
    assert [res[r] for r in rids] == [ref[0], ref[1]]

    # the dead incarnation's ghost: a stale-attempt report must be dropped
    ghost_out = fleet.workers[1].recv
    ghost_out.send({"kind": "report", "attempt": 0, "step": 99,
                    "toks": {str(rids[0]): [123]}, "done": {}})

    # rejoin: fresh incarnation, bumped attempt, fresh beats -> live again
    inbox, outbox = LocalMailbox(), LocalMailbox()
    fleet.attach(1, send=inbox, recv=outbox)
    assert fleet.workers[1].attempt == 1
    workers[1] = _worker(lm_setup, sc, 1, inbox, outbox, attempt=1)
    before = dict(fleet.results())
    rids2 = [fleet.submit(p) for p in prompts[2:]]
    res2 = _drive(fleet, workers, clock)
    assert [res2[r] for r in rids2] == [ref[2], ref[3]]
    assert fleet.workers[1].served > 0, "returned worker got no work"
    # the ghost report changed nothing
    assert {r: res2[r] for r in rids} == {r: before[r] for r in rids}


# ----------------------------------------------------------------- admission
def test_fleet_paged_never_fits_rejected(lm_setup):
    sc = ServeConfig(slots=2, max_len=48, max_new_tokens=20,
                     block_size=4, pool_blocks=3)
    fleet = FleetEngine(sc, world=1, clock=_Clock())
    with pytest.raises(ValueError, match="blocks"):
        fleet.submit(np.arange(1, 9, dtype=np.int32))


def test_fleet_deadline_cancels_inflight(lm_setup):
    sc = ServeConfig(slots=1, max_len=48, max_new_tokens=30)
    clock = _Clock()
    fleet, workers = _build_fleet(lm_setup, sc, world=1, clock=clock)
    rid = fleet.submit(np.array([3, 1, 4], np.int32), deadline_s=0.5)
    for n in range(4):  # assign + a few decode steps
        fleet.tracker.observe({0: n})
        fleet.tick()
        workers[0].tick()
        clock.t += 0.01
    clock.t = 1.0  # past the deadline while ACTIVE on the worker
    fleet.tracker.observe({0: 9})
    fleet.tick()  # coordinator times it out + sends cancel
    req = fleet.router.done[rid]
    assert req.status == "timeout" and 0 < len(req.out) < 30
    for _ in range(3):  # worker processes the cancel and frees the lane
        workers[0].tick()
    assert len(workers[0].engine.planes[0].free_slots()) == 1
    assert fleet.pending() == 0


def _restore_drift(mod, cfg, params, prompt, prefix, max_len, torch_side):
    """max |logits of a prefill of prompt + prefix - logits of the decode
    steps over prefix after a prefill of prompt|, and whether the argmax of
    every lane agrees."""
    dev = {"device": "cpu"} if torch_side else {}
    tok = (lambda a: torch.as_tensor(a, dtype=torch.long)) if torch_side else jnp.asarray
    b = prompt.shape[0]
    logits, cache, lengths = mod.prefill(params, cfg, tok(prompt),
                                         mod.init_cache(cfg, b, max_len, **dev))
    for i in range(prefix.shape[1]):
        logits, cache = mod.decode_step(params, cfg, tok(prefix[:, i:i + 1]), cache, lengths)
        lengths = lengths + 1
    again = mod.prefill(params, cfg, tok(np.concatenate([prompt, prefix], 1)),
                        mod.init_cache(cfg, b, max_len, **dev))[0]
    dec, pre = (np.asarray(torch.as_tensor(x).float() if torch_side
                           else jnp.asarray(x, jnp.float32)) for x in (logits, again))
    return float(np.abs(dec - pre).max()), bool((dec.argmax(-1) == pre.argmax(-1)).all())


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "qwen1.5-4b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_restored_logits_round_like_jax(arch, dtype):
    """Why a restore is exact only up to rounding: the logits a re-prefill
    computes against the decode step's they replace, in both packages
    (printed; 4 lanes, prompts of 12, a prefix of 8, past the smoke
    window of 16).  float32: within 1e-5 in both; bf16: the port's drift at
    most twice JAX's."""
    jcfg, tcfg, jparams, tparams = bridge(arch, seed=1, dtype=dtype)
    rng = np.random.default_rng(0)
    prompt, prefix = (rng.integers(0, 120, (4, n)).astype(np.int32) for n in (12, 8))
    theirs = _restore_drift(jm, jcfg, jparams, prompt, prefix, 64, torch_side=False)
    with torch.no_grad():
        ours = _restore_drift(tm, tcfg, tparams, prompt, prefix, 64, torch_side=True)
    print(f"{arch} {dtype}: restore - decode logits max |diff| (argmax equal): "
          f"JAX {theirs[0]} ({theirs[1]}), port {ours[0]} ({ours[1]})")
    if dtype == "float32":
        assert theirs[0] <= 1e-5 and ours[0] <= 1e-5
    else:
        assert ours[0] <= 2 * theirs[0]
