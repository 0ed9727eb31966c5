"""The port's router and fleet (``paddle_tpu_torch/serving/router.py``,
``fleet.py``) against the JAX package's on the CPU: ``chain_keys`` against
the JAX router's and the port pool's, each placement policy and the
autoscaler on the JAX tests' ``ReplicaState`` fixtures, and live fleets of
a tiny f32 Llama (loaded from the JAX model through
``load_paddle_tpu_state``; JAX with ``interpret=True``): failover token
for token against the JAX ``Fleet`` on the same schedule and kill step and
against one port engine that meets no fault, the failover's trace events
against JAX's, queue transfer FCFS, the last replica, nothing routable,
misroutes, affinity against round robin, scale-up then a graceful
retire, an int8 pool, and the one stack of fused weights the replicas
share.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import AffinityRouter as JaxAffinity
from paddle_tpu.serving import AutoscalerPolicy as JaxAutoscaler
from paddle_tpu.serving import Fleet as JaxFleet
from paddle_tpu.serving import LoadAwareRouter as JaxLoadAware
from paddle_tpu.serving import ReplicaState as JaxState
from paddle_tpu.serving import RoundRobinRouter as JaxRoundRobin
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving.router import chain_keys as jax_chain_keys
from paddle_tpu_torch.core import faults, metrics
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.kv_cache import KVCacheSpec
from paddle_tpu_torch.serving import (AffinityRouter, AutoscalerPolicy,
                                      BlockPool, Fleet, LoadAwareRouter,
                                      ReplicaState, RoundRobinRouter,
                                      ServingConfig, ServingEngine, router)
from paddle_tpu_torch.serving.router import chain_keys

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
BASE = dict(max_seq_len=64, block_size=8, prefill_buckets=(16,),
            max_batch=4, prefill_token_budget=16)
NEW = 6


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(n=5, lens=(7, 5, 9, 13, 20)):
    rng = np.random.RandomState(23)
    return [rng.randint(0, 256, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _fleet(tm, replicas=2, **kw):
    fkw = {k: kw.pop(k) for k in ("router", "autoscaler",
                                  "autoscale_interval") if k in kw}
    return Fleet(tm, ServingConfig(**dict(BASE, **kw)), replicas=replicas,
                 device="cpu", **fkw)


def _pair(models, router="affinity", **kw):
    """A JAX and a port fleet of 2 replicas on one config. Their policies
    get ``slo_step_ms=0``: the step-p99 term of the load score is host
    time, so with it placements would follow the clock."""
    jm, tm = models
    mk = {"affinity": (AffinityRouter, JaxAffinity),
          "round_robin": (RoundRobinRouter, JaxRoundRobin)}[router]
    arg = {} if router == "round_robin" else {"slo_step_ms": 0}
    return (JaxFleet(jm, JaxServingConfig(interpret=True, **dict(BASE, **kw)),
                     replicas=2, router=mk[1](**arg)),
            _fleet(tm, router=mk[0](**arg), **kw))


def _plain(tm, prompts, new, **kw):
    """The streams of one port engine that meets no fault."""
    eng = ServingEngine(tm, ServingConfig(**dict(BASE, **kw)))
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run_until_complete()
    return [r.tokens for r in reqs]


def _events(req, labels):
    """A request's events without timestamps, engine labels mapped to
    replica indices (label ids are per process)."""
    out = []
    for e in req.trace_events:
        e = {k: v for k, v in e.items() if k != "ts"}
        if "engine" in e:
            e["engine"] = labels[e["engine"]]
        out.append(e)
    return out


def _labels(fleet):
    return {rep.engine.metrics_labels["engine"]: rep.index
            for rep in fleet.replicas}


# -- affinity keys ------------------------------------------------------------------
@pytest.mark.parametrize("bs,n", [(8, 29), (8, 16), (8, 17), (16, 40),
                                  (4, 1), (8, 0)])
def test_chain_keys_match_jax_and_the_pool(models, bs, n):
    tokens = np.random.RandomState(5).randint(0, 256, (n,)).astype(np.int32)
    spec = KVCacheSpec.from_config(models[1].config, page_size=bs)
    pool = BlockPool(spec, max_seq_len=64, num_blocks=8, max_slots=4,
                     optimistic=True, prefix_cache=True)
    assert chain_keys(tokens, bs) == jax_chain_keys(tokens, bs)
    assert len(chain_keys(tokens, bs)) == max((n - 1) // bs, 0)
    for n_blocks in range(n // bs + 1):
        assert chain_keys(tokens, bs, n_blocks) == \
            jax_chain_keys(tokens, bs, n_blocks) == \
            pool._chain_keys(tokens, n_blocks)


def test_chain_keys_are_chained_not_positional():
    a = chain_keys(np.arange(24), 8, 2)
    b = chain_keys(np.concatenate([np.arange(8) + 1, np.arange(8, 16)]), 8, 2)
    assert a[0] != b[0] and a[1] != b[1]
    assert chain_keys(np.arange(24), 16, 1) != chain_keys(np.arange(24), 8, 1)


# -- policies on fixtures -------------------------------------------------------------
def _states(cls, specs):
    base = dict(max_batch=4, usable_blocks=12, free_blocks=12)
    return [cls(index=i, **dict(base, **kw)) for i, kw in specs]


# (policy, its kwargs, the states' (index, fields), hits, JAX's answer)
POLICY_CASES = [
    ("affinity", {"spill": 4}, [(0, {}), (1, {}), (2, {})], {1: 3}, 1),
    ("affinity", {"spill": 4}, [(0, {}), (1, {})], {0: 1, 1: 3}, 1),
    ("affinity", {"spill": 4}, [(0, {"active": 4, "queued": 2}), (1, {})],
     {0: 3}, 1),
    ("affinity", {"spill": 4}, [(0, {"active": 3}), (1, {})], {0: 3}, 0),
    ("affinity", {"spill": 4}, [(0, {"active": 3, "queued": 2}), (1, {})],
     {}, 1),
    ("affinity", {"spill": 4}, [(2, {}), (0, {}), (1, {})], {1: 2, 2: 2}, 1),
    ("affinity", {"spill": 0}, [(0, {"alive": False}),
                                (1, {"draining": True})], {0: 5}, None),
    ("load_aware", {"slo_step_ms": 1000}, [
        (0, {"alive": False}), (1, {"draining": True}),
        (2, {"active": 4, "queued": 6})], None, 2),
    ("load_aware", {"slo_step_ms": 1000}, [
        (0, {"active": 2, "free_blocks": 1}),
        (1, {"active": 2, "free_blocks": 10})], None, 1),
    ("load_aware", {"slo_step_ms": 1000}, [
        (0, {"step_p99_ms": 5000.0}), (1, {"step_p99_ms": 50.0})], None, 1),
    ("load_aware", {"slo_step_ms": 0}, [
        (0, {"step_p99_ms": 5000.0}), (1, {"step_p99_ms": 50.0})], None, 0),
    ("load_aware", {"slo_step_ms": 1000}, [(2, {}), (0, {}), (1, {})],
     None, 0),
    ("load_aware", {"slo_step_ms": 1000}, [
        (0, {"decode_stalls": 5, "iterations": 10}), (1, {"queued": 1})],
     None, 1),
    ("round_robin", {}, [(0, {"alive": False}), (1, {"draining": True})],
     None, None),
]
POLICIES = {"affinity": (AffinityRouter, JaxAffinity),
            "load_aware": (LoadAwareRouter, JaxLoadAware),
            "round_robin": (RoundRobinRouter, JaxRoundRobin)}


@pytest.mark.parametrize("name,kw,specs,hits,want", POLICY_CASES)
def test_policies_choose_as_jax(name, kw, specs, hits, want):
    ours, ref = POLICIES[name]
    got = [[cls(**kw).choose(_states(st, specs), hits=hits) for _ in range(3)]
           for cls, st in ((ours, ReplicaState), (ref, JaxState))]
    assert got[0] == got[1] == [want] * 3


def test_round_robin_cycles_routable_only_as_jax():
    specs = [(0, {}), (1, {"draining": True}), (2, {})]
    got = [[r.choose(_states(st, specs)) for _ in range(5)]
           for r, st in ((RoundRobinRouter(), ReplicaState),
                         (JaxRoundRobin(), JaxState))]
    assert got[0] == got[1] == [0, 2, 0, 2, 0]


def test_load_scores_and_defaults_match_jax():
    rng = np.random.RandomState(9)
    for _ in range(20):
        kw = dict(active=int(rng.randint(0, 8)), queued=int(rng.randint(0, 9)),
                  prefilling=int(rng.randint(0, 3)),
                  free_blocks=int(rng.randint(0, 40)),
                  usable_blocks=int(rng.randint(1, 40)),
                  decode_stalls=int(rng.randint(0, 5)),
                  iterations=int(rng.randint(0, 50)),
                  step_p99_ms=float(rng.uniform(1, 20000)), max_batch=8)
        for slo in (0.0, 1000.0, 50.0):
            assert ReplicaState(0, **kw).load_score(slo) == \
                JaxState(0, **kw).load_score(slo)
    assert ReplicaState(0).load_score() == JaxState(0).load_score()
    assert AffinityRouter().spill == JaxAffinity().spill
    assert LoadAwareRouter().slo_step_ms == JaxLoadAware().slo_step_ms
    assert repr(AutoscalerPolicy()) == repr(JaxAutoscaler())


# (states, steps since the last action, policy kwargs, JAX's decision)
AUTOSCALE_CASES = [
    ([(0, {"active": 4, "queued": 9})], None, {}, "add"),
    ([(0, {"active": 4, "queued": 9})], 3, {}, "hold"),
    ([(0, {"active": 4, "queued": 9})], 8, {}, "add"),
    ([(0, {"active": 1}), (1, {})], None, {}, "drain"),
    ([(0, {})], None, {}, "hold"),
    ([(0, {"queued": 9}), (1, {"queued": 9})], None, {"max_replicas": 2},
     "hold"),
    ([(0, {"active": 3, "queued": 1}), (1, {"active": 2})], None, {}, "hold"),
    ([(0, {"queued": 9}), (1, {"draining": True})], None, {}, "add"),
    ([(0, {"alive": False})], None, {}, "add"),
    ([(0, {"alive": False})], None, {"max_replicas": 0}, "hold"),
]


@pytest.mark.parametrize("specs,since,kw,want", AUTOSCALE_CASES)
def test_autoscaler_decides_as_jax(specs, since, kw, want):
    base = dict(scale_up_queue=4.0, scale_down_util=0.25, min_replicas=1,
                max_replicas=8, cooldown=8)
    base.update(kw)
    got = [cls(**base).decide(_states(st, specs), since)
           for cls, st in ((AutoscalerPolicy, ReplicaState),
                           (JaxAutoscaler, JaxState))]
    assert got[0] == got[1] == want


# -- live fleets ---------------------------------------------------------------------
def _failover(fleet, prompts, steps, victim=None):
    reqs = [fleet.submit(p, NEW, rid=f"f{i}") for i, p in enumerate(prompts)]
    for _ in range(steps):
        fleet.step()
    victim = fleet._pick_victim({}) if victim is None else victim
    h = fleet.replicas[victim].engine.health()
    live = h["active"] + h["prefilling"] + h["queued"]
    moved = fleet.kill_replica(victim)
    fleet.run_until_complete()
    return reqs, victim, live, moved


@pytest.mark.parametrize("kv", ["", "int8"], ids=["f32_pool", "int8_pool"])
def test_failover_matches_jax_fleet_and_a_plain_engine(models, kv):
    """Kill the busiest replica mid-flight: placements, victim, moved
    requests, every token and every trace event (labels mapped to replica
    indices) equal the JAX fleet's on the same schedule; on an f32 pool
    the streams also equal one engine's that meets no fault. The dead
    replica keeps its blocks and leaves a ``replica_die`` postmortem with
    ring records; the survivor drains whole."""
    tm = models[1]
    prompts = _prompts(6)
    out = []
    for f, fleet in zip((jax_faults, faults),
                        _pair(models, kv_cache_dtype=kv)):
        f.reset_stats()
        out.append((fleet,) + _failover(fleet, prompts, 3))
    (jf, jreqs, jv, jlive, jmoved), (fl, reqs, v, live, moved) = out
    assert (v, live, moved) == (jv, jlive, jmoved) and moved == live > 0
    assert fl.rerouted + fl.queue_transfers == moved
    assert (fl.rerouted, fl.queue_transfers) == (jf.rerouted,
                                                 jf.queue_transfers)
    for r, j in zip(reqs, jreqs):
        assert r.status == j.status == "finished", (r.rid, r.error)
        assert r.tokens == j.tokens, r.rid
        assert fl.placement(r.rid) == jf.placement(j.rid)
        assert _events(r, _labels(fl)) == _events(j, _labels(jf)), r.rid
    died = [r for r in reqs
            if any(e["event"] == "replica_die" for e in r.trace_events)]
    assert len(died) == moved
    assert all(fl.placement(r.rid) != v for r in died)
    assert any(e["event"] == "recompute" for r in died
               for e in r.trace_events)
    if not kv:
        assert [r.tokens for r in reqs] == _plain(tm, prompts, NEW)
    dead = fl.replicas[v].engine
    pm = [p for p in dead.flight_recorder.postmortems
          if p["reason"] == "replica_die"]
    assert len(pm) == 1 and pm[0]["records"]
    assert pm[0]["context"]["inflight"] + pm[0]["context"]["queued"] == moved
    assert dead.health()["draining"] and dead.health()["postmortems"] == 1
    assert dead.pool.free_blocks < dead.pool.usable_blocks
    stats = fl.drain()
    assert v not in stats and len(stats) == 1
    for rep in fl.replicas:
        if not rep.dead:
            assert rep.engine.pool.free_blocks == \
                rep.engine.pool.usable_blocks
    h = fl.health()
    assert (h["failovers"], h["live"], h["routable"]) == (1, 1, 1)
    assert [r["state"] for r in h["replicas"]] == \
        ["dead" if i == v else "live" for i in range(2)]
    jf.drain()


def test_replica_die_fault_point_kills_the_pinned_replica(models):
    tm = models[1]
    fleet = _fleet(tm)
    reqs = [fleet.submit(p, NEW) for p in _prompts(4)]
    fleet.step()
    with faults.inject("fleet.replica_die", at=1, replica=1):
        fleet.step()
    assert fleet.replicas[1].dead and fleet.failovers == 1
    pm = fleet.replicas[1].engine.flight_recorder.postmortems[-1]
    assert pm["context"]["cause"] == "fault injection: fleet.replica_die"
    with faults.inject("fleet.replica_die", every=1):
        fleet.run_until_complete()         # no sibling: the probe holds
    assert fleet.failovers == 1
    assert [r.tokens for r in reqs] == _plain(tm, _prompts(4), NEW)
    fleet.drain()


def test_queue_transfer_keeps_fcfs(models):
    """Never-admitted requests move off the dead replica's queue FCFS and
    finish in their submission order."""
    tm = models[1]
    fleet = _fleet(tm, max_batch=1)
    prompts = _prompts(6, lens=(7,))
    reqs = [fleet.submit(p, 4, rid=f"q{i}") for i, p in enumerate(prompts)]
    fleet.step()
    victim = next(rep.index for rep in fleet.replicas
                  if rep.engine.health()["queued"] > 0)
    fleet.kill_replica(victim)
    assert fleet.queue_transfers >= 2
    moved = [r for r in reqs
             if any(e["event"] == "adopt" for e in r.trace_events)]
    assert len(moved) == fleet.queue_transfers
    fleet.run_until_complete()
    assert [r.tokens for r in reqs] == _plain(tm, prompts, 4, max_batch=1)
    order = [r.rid for r in sorted(moved, key=lambda r: r.t_done)]
    assert order == sorted(order)
    assert fleet.replicas[1 - victim].engine.scheduler.stats()[
        "submitted"] == 3                   # adopted, not submitted again
    fleet.drain()


def test_cannot_kill_the_last_live_replica(models):
    fleet = _fleet(models[1], replicas=1)
    with pytest.raises(RuntimeError, match="last live replica"):
        fleet.kill_replica(0)
    assert fleet.replicas[0].live


def test_submit_with_nothing_routable_raises(models):
    fleet = _fleet(models[1], replicas=2)
    fleet.replicas[0].retiring = True
    fleet.kill_replica(1)
    with pytest.raises(RuntimeError, match="no routable replica"):
        fleet.submit(np.arange(5, dtype=np.int32), max_new_tokens=2)
    assert fleet.kill_replica(1) == 0           # already dead


def test_misroute_is_a_loss_of_optimisation_only(models):
    """Every decision perturbed, in both packages alike: the placements
    move, the tokens do not, and both replicas drain."""
    prompts = _prompts(5)
    out = []
    for f, fleet in zip((jax_faults, faults), _pair(models)):
        with f.inject("fleet.route_misroute", every=1):
            reqs = [fleet.submit(p, NEW) for p in prompts]
            fleet.run_until_complete()
        out.append((fleet, [fleet.placement(r.rid) for r in reqs], reqs))
        fleet.drain()
    (jf, jplaced, _), (fleet, placed, reqs) = out
    assert fleet.misroutes == jf.misroutes == 5 and placed == jplaced
    assert all(r.status == "finished" for r in reqs)
    assert [r.tokens for r in reqs] == _plain(models[1], prompts, NEW)
    snap = metrics.snapshot()["counters"]
    lk = metrics.label_key(**fleet.metrics_labels)
    assert snap["fleet.misroutes"][lk] == 5 and snap["fleet.routed"][lk] == 5


def test_affinity_saves_more_prefill_than_round_robin_as_jax(models):
    """Paced arrivals over 3 shared prefixes: affinity keeps each group on
    the replica holding its chain; the placements and the saved prefill
    tokens equal the JAX fleet's for both policies."""
    rng = np.random.RandomState(31)
    prefixes = [rng.randint(0, 256, (16,)).astype(np.int32)
                for _ in range(3)]
    prompts = [np.concatenate([prefixes[i % 3], rng.randint(
        0, 256, (5,)).astype(np.int32)]) for i in range(9)]

    def drive(fleet):
        reqs = []
        for p in prompts:
            reqs.append(fleet.submit(p, max_new_tokens=2))
            fleet.step()
            fleet.step()
        fleet.run_until_complete()
        saved = sum(rep.engine.stats()["pool"]["prefix_saved_tokens"]
                    for rep in fleet.replicas)
        fleet.drain()
        return [fleet.placement(r.rid) for r in reqs], saved, reqs

    got = {}
    for name in ("affinity", "round_robin"):
        jf, fleet = _pair(models, router=name)
        ref, ours = drive(jf), drive(fleet)
        assert ours[:2] == ref[:2], name
        assert [r.tokens for r in ours[2]] == [r.tokens for r in ref[2]]
        got[name] = ours[1]
    assert got["affinity"] > got["round_robin"], got


def test_scale_up_then_graceful_retire(models):
    tm = models[1]
    fleet = _fleet(tm, replicas=1, max_batch=2,
                   autoscaler=AutoscalerPolicy(
                       scale_up_queue=1.0, scale_down_util=0.25,
                       min_replicas=1, max_replicas=4, cooldown=2),
                   autoscale_interval=2)
    prompts = _prompts(8, lens=(7, 5, 9, 6))
    reqs = [fleet.submit(p, 4) for p in prompts]
    fleet.run_until_complete()
    assert fleet.autoscale_ups >= 1 and len(fleet.replicas) > 1
    assert all(r.status == "finished" for r in reqs)
    assert [r.tokens for r in reqs] == _plain(tm, prompts, 4)
    first = fleet.replicas[0].engine
    for rep in fleet.replicas[1:]:
        assert rep.engine.weights.qkv_w.data_ptr() == \
            first.weights.qkv_w.data_ptr()
    for _ in range(40):
        fleet.step()
        if fleet.health()["routable"] == 1:
            break
    assert fleet.autoscale_downs >= 1
    retired = [r for r in fleet.replicas if r.retired]
    assert retired
    for rep in retired:
        assert rep.engine.pool.free_blocks == rep.engine.pool.usable_blocks
    states = fleet.replica_states()
    assert len(states) == len(fleet.replicas) - len(retired)
    fleet.drain()


def test_replicas_share_one_stack_of_weights(models):
    """Every replica's fused weights, embedding, f32 head and rope tables
    are the first replica's storage; the page buffers are each its own."""
    tm = models[1]
    fleet = _fleet(tm, replicas=3, speculative=(tm, 2))
    stacks = [rep.engine._target for rep in fleet.replicas]
    drafts = [rep.engine._drafter for rep in fleet.replicas]
    w0 = stacks[0].weights
    for st, dr in zip(stacks[1:], drafts[1:]):
        for name in ("qkv_w", "out_w", "ffn1_w", "ffn2_w", "ln_scale",
                     "ffn_ln_scale"):
            assert getattr(st.weights, name).data_ptr() == \
                getattr(w0, name).data_ptr(), name
        for name in ("embed", "final_norm", "head", "cos", "sin"):
            assert getattr(st, name).data_ptr() == \
                getattr(stacks[0], name).data_ptr(), name
        assert dr.weights is st.weights
    pools = [rep.engine.pool.k_pages.data_ptr() for rep in fleet.replicas]
    pools += [rep.engine.pool.draft_k_pages.data_ptr()
              for rep in fleet.replicas]
    assert len(set(pools)) == 6
    prompts = _prompts(4)
    reqs = [fleet.submit(p, NEW) for p in prompts]
    fleet.run_until_complete()
    assert [r.tokens for r in reqs] == _plain(tm, prompts, NEW)
    fleet.drain()


def test_share_weights_with_refuses_another_config(models):
    tm = models[1]
    a = ServingEngine(tm, ServingConfig(**BASE))
    with pytest.raises(ValueError, match="share_weights_with"):
        ServingEngine(tm, ServingConfig(**dict(BASE, max_batch=2)),
                      share_weights_with=a)


def test_replica_states_health_and_serve_surface(models):
    fleet = _fleet(models[1], replicas=2)
    states = fleet.replica_states()
    assert [s.index for s in states] == [0, 1]
    for s in states:
        assert s.alive and s.routable and s.max_batch == 4
        assert s.usable_blocks >= s.free_blocks > 0
    h = fleet.health()
    assert h["router"] == "affinity" and h["live"] == h["routable"] == 2
    assert [r["state"] for r in h["replicas"]] == ["live", "live"]
    doc = metrics.health_snapshot(include_metrics=False)
    assert any(f["fleet"] == fleet.metrics_labels["fleet"]
               for f in doc["fleet"]["fleets"])
    srv = fleet.serve()
    try:
        assert srv.url.startswith("http://127.0.0.1:")
    finally:
        srv.close()
    with pytest.raises(ValueError, match="unknown router"):
        _fleet(models[1], router="nope")
    with pytest.raises(TypeError):
        _fleet(models[1], router=object())
    with pytest.raises(ValueError):
        _fleet(models[1], replicas=0)
    fleet.drain()


def test_fleet_runs_on_the_card_unless_told_otherwise(models):
    """Without ``device`` a fleet of a CPU model runs on the CPU, as the
    engine does; asked for CUDA without a card it raises."""
    tm = models[1]
    assert Fleet(tm, ServingConfig(**BASE)).replicas[0].engine.device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, ValueError)):
            Fleet(tm, ServingConfig(**BASE), device="cuda")


def test_fleet_defaults_match_jax():
    from paddle_tpu.core.flags import flag

    for name in ("slo_step_ms", "affinity_spill", "scale_up_queue",
                 "scale_down_util", "min_replicas", "max_replicas",
                 "autoscale_cooldown"):
        assert getattr(router, f"FLEET_{name.upper()}") == \
            flag(f"fleet_{name}"), name
