"""PyTorch port: serve-fleet fault tolerance — ``HealthMonitor``,
``PagedServingEngine.drain`` / ``restore`` (warm with the K/V blocks,
or cold), ``Scheduler.adopt`` and ``FleetSupervisor`` under
``ChaosMonkey``.

The counterparts of ``tests/test_checkpoint_ft.py``'s fleet tests, on
the same smoke model and options, plus an 8-episode chaos sweep (greedy
and sampled rows token-identical to an unfaulted fleet) and one chaos
episode held against the JAX ``FleetSupervisor``: greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.ft import ChaosMonkey as JaxChaos
from repro.ft import FleetSupervisor as JaxFleet
from repro.models import lm as jlm
from repro.models import params as jparams
from repro.serve import Request as JaxRequest
from repro.serve import ServeOptions as JaxOptions
from repro.serve import build_engine as jax_build
from repro_torch import obs
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.ft import (
    ChaosMonkey,
    EngineHealth,
    FleetSupervisor,
    HealthMonitor,
)
from repro_torch.models import params as tparams
from repro_torch.serve import Request, ServeOptions, build_engine

_OPTS = dict(paged=True, slots=2, max_len=48, block_size=4,
             prefill_chunk=3, seed=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke("qwen2-0.5b").replace(
        param_dtype=jnp.float32, act_dtype=jnp.float32
    )
    tcfg = torch_smoke("qwen2-0.5b").replace(
        param_dtype=torch.float32, act_dtype=torch.float32
    )
    params = jparams.init_params(
        jax.random.PRNGKey(1), jlm.lm_param_specs(jcfg), jnp.float32
    )
    tp = tparams.params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu"
    )
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=params, params=tp)


def _engine(setup, tracer=None, **kw):
    opts = ServeOptions(**{**_OPTS, **kw})
    return build_engine(setup["params"], setup["tcfg"], opts, device="cpu",
                        tracer=tracer)


def _fleet(setup, tracer=None, **kw):
    kw.setdefault("shards", 2)
    return FleetSupervisor(lambda s: _engine(setup, tracer), **kw)


def _reqs(rid0, n=2, max_new=3, cls=Request):
    return [cls(rid=rid0 + j, prompt=[3 + j, 9, 17, 3, 11, 5],
                max_new_tokens=max_new,
                temperature=0.8 if j % 2 else 0.0)
            for j in range(n)]


def test_windowed_monitor_judges_deltas_not_lifetime():
    """A readmitted shard is judged on deltas: counters are monotonic,
    so a lifetime monitor would blacklist a once-degraded shard."""
    win = HealthMonitor(window=True)
    assert win.observe(EngineHealth(ticks=2, errors=1, error_rate=0.5))
    assert not win.observe(EngineHealth(ticks=6, errors=1,
                                        error_rate=1 / 6))
    life = HealthMonitor()
    assert life.observe(EngineHealth(ticks=6, errors=1, error_rate=1 / 6))
    backlog = HealthMonitor(max_queue_depth=1, patience=2)
    assert not backlog.observe(EngineHealth(queue_depth=3))
    assert backlog.observe(EngineHealth(queue_depth=3))


def test_warm_resume_restores_kv_instead_of_reprefilling(setup):
    """A request drained mid-decode resumes WARM on a fresh engine: the
    K/V payload is written into its pools, the prompt is never re-fed,
    and the tokens equal an uninterrupted run's."""
    prompt = [5, 9, 17, 3, 11, 5]
    ref_eng = _engine(setup)
    ref_eng.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=6))
    ref = ref_eng.run_until_drained()[0].generated

    src = _engine(setup)
    src.submit(Request(rid=0, prompt=list(prompt), max_new_tokens=6))
    for _ in range(4):  # past prefill, mid-decode
        src.step()
    ckpts = src.drain()
    assert len(ckpts) == 1 and ckpts[0]["kv"] is not None
    assert ckpts[0]["fed"] > 0
    assert ckpts[0]["kv"]["k"].device.type == "cpu"
    assert not src.scheduler.has_work() and src.kv.live_blocks == 0
    dst = _engine(setup)
    assert dst.restore(ckpts[0]) is True
    done = dst.run_until_drained()
    assert done[0].generated == ref
    refed = dst.metrics.value("serve_prefill_tokens_total") or 0
    assert refed < len(prompt)


def test_cold_resume_from_waiting_queue_recomputes(setup):
    """Requests drained from the waiting queue resume cold (a plain
    re-submit), a mismatched block size resumes cold too, and every
    token equals an uninterrupted run's."""
    src = _engine(setup, slots=1)
    for r in _reqs(30, n=3):
        src.submit(r)
    src.step()  # admits rid 30 only
    ckpts = src.drain()
    assert len(ckpts) == 3
    assert sum(c["kv"] is not None for c in ckpts) == 1
    dst = _engine(setup, slots=1)
    assert [dst.restore(c) for c in ckpts].count(True) == 1
    done = {r.rid: r.generated for r in dst.run_until_drained()}
    ref_eng = _engine(setup, slots=1)
    for r in _reqs(30, n=3):
        ref_eng.submit(r)
    ref = {r.rid: r.generated for r in ref_eng.run_until_drained()}
    assert done == ref
    # another geometry cannot take the payload: cold, same tokens
    src = _engine(setup, slots=1)
    src.submit(_reqs(30, n=1)[0])
    src.step()
    (ckpt,) = src.drain()
    other = _engine(setup, slots=1, block_size=8)
    assert other.restore(ckpt) is False
    assert other.run_until_drained()[0].generated == ref[30]


def test_fleet_degrade_drain_resume_readmit_cycle(setup):
    fleet = _fleet(setup, cooldown=2)
    for r in _reqs(0, n=4, max_new=4):
        fleet.submit(r)
    fleet.step()
    ckpts = fleet.degrade(1)
    assert not fleet.healthy[1] and fleet.drains == 1
    assert len(ckpts) == 2  # round-robin put 2 on shard 1
    assert not fleet.engines[1].scheduler.has_work()
    assert fleet.resumed == len(ckpts)
    m = fleet.metrics
    assert m.value("ft_shard_drains_total", shard="1") == 1
    assert m.value("ft_requests_resumed_total", shard="0") == len(ckpts)
    assert m.value("ft_shard_degraded_total", shard="0") == 0
    assert fleet.degrade(1) == [] and fleet.drains == 1  # idempotent
    fleet.poll()
    fleet.poll()
    assert fleet.healthy[1] and fleet.readmissions == 1
    assert m.value("ft_shard_readmissions_total", shard="1") == 1
    done = fleet.run_until_drained()
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(len(r.generated) == 4 for r in done)
    assert fleet.engines[0].health_snapshot()["errors"] == 0


def test_degrade_with_no_healthy_target_raises(setup):
    fleet = _fleet(setup)
    fleet.degrade(0)
    with pytest.raises(RuntimeError, match="no healthy shard"):
        fleet.degrade(1)


def test_stale_heartbeat_drains_the_silent_shard(setup):
    fleet = _fleet(setup)
    for r in _reqs(10, n=2):
        fleet.submit(r)
    fleet.last_heartbeat[1] = -1e18  # shard 1 went silent
    fleet.poll()
    assert not fleet.healthy[1] and fleet.healthy[0]
    assert fleet.drains == 1
    done = fleet.run_until_drained()
    assert sorted(r.rid for r in done) == [10, 11]


def test_a_raising_tick_is_counted_and_drained(setup):
    """A shard whose tick raises counts ``serve_errors_total`` itself;
    the fleet's poll drains it and its requests finish elsewhere."""
    fleet = _fleet(setup)
    for r in _reqs(40, n=4):
        fleet.submit(r)
    fleet.step()
    eng = fleet.engines[1]

    def broken():
        raise RuntimeError("lost device")

    eng._tick = broken
    fleet.step()
    assert eng.metrics.value("serve_errors_total") == 1
    (failure,) = fleet.failures
    assert failure[:2] == (1, 1) and "lost device" in str(failure[2])
    assert not fleet.healthy[1] and fleet.drains == 1
    done = fleet.run_until_drained()
    assert sorted(r.rid for r in done) == [40, 41, 42, 43]


def test_chaos_sweep_token_identity_8_episodes(setup):
    """8 chaos episodes (injection tick and victim shard vary) against
    an unfaulted fleet with the same engine seed: every request
    finishes and every token, greedy and sampled, is the unfaulted
    run's."""
    fleet = _fleet(setup, cooldown=2)
    ref = _fleet(setup)
    for ep in range(8):
        while not all(fleet.healthy):
            fleet.poll()
        for r in _reqs(100 + ep * 10, n=2):
            fleet.submit(r)
        for r in _reqs(100 + ep * 10, n=2):
            ref.submit(r)
        fleet.chaos = ChaosMonkey(at_tick=fleet.ticks + 1 + ep % 3,
                                  shard=ep % 2, errors=2)
        fleet.run_until_drained()
        ref.run_until_drained()
    got = {r.rid: r.generated for r in fleet.finished}
    want = {r.rid: r.generated for r in ref.finished}
    assert len(got) == 16 and got == want
    assert fleet.drains >= 6 and fleet.resumed >= 2
    assert ref.drains == 0


def test_chaos_episode_greedy_tokens_match_reference_fleet(setup):
    """One chaos episode (4 requests, shard 1 degraded at tick 2) in
    both packages: the same drains and resumes, equal greedy tokens
    (sampled rows agree in distribution only)."""
    jfleet = JaxFleet(
        lambda s: jax_build(setup["jparams"], setup["jcfg"],
                            JaxOptions(**_OPTS)),
        shards=2, chaos=JaxChaos(at_tick=2, shard=1, errors=2),
    )
    tracer = obs.Tracer()
    tfleet = _fleet(setup, tracer,
                    chaos=ChaosMonkey(at_tick=2, shard=1, errors=2))
    for r in _reqs(0, n=4, max_new=4, cls=JaxRequest):
        jfleet.submit(r)
    for r in _reqs(0, n=4, max_new=4):
        tfleet.submit(r)
    jdone = {r.rid: r for r in jfleet.run_until_drained()}
    tdone = {r.rid: r for r in tfleet.run_until_drained()}
    assert sorted(tdone) == sorted(jdone) == [0, 1, 2, 3]
    assert (tfleet.drains, tfleet.resumed) == (jfleet.drains, jfleet.resumed)
    assert tfleet.drains == 1 and tfleet.resumed >= 1
    for rid in (0, 2):  # the greedy rows
        assert tdone[rid].generated == jdone[rid].generated, rid
    for rid in (1, 3):
        assert len(tdone[rid].generated) == len(jdone[rid].generated)
    resumes = [s.attrs for s in tracer.spans if s.name == "request.resume"]
    assert len(resumes) == tfleet.resumed
    assert any(a["warm"] and a["fed"] > 0 for a in resumes)
