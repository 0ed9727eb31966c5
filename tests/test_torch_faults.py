"""The port's fault points and request lifecycle on the CPU: the
``core/faults.py`` registry and schedules against the JAX harness, the NaN
sentinel at each of its points against the JAX engine (``interpret=True``)
on a tiny f32 Llama loaded through ``load_paddle_tpu_state``, and
cancellation, deadlines, a raising ``on_token`` callback, ``drain`` and
``evacuate`` on the port's ``ServingEngine``.
"""

import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.core import faults
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
BASE = dict(max_seq_len=64, block_size=8, prefill_buckets=(16,),
            max_batch=4, prefill_token_budget=16)
NEW = 10


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lens=(5, 30, 13, 9)):
    rng = np.random.RandomState(17)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


def _run(engine, prompts, **kw):
    reqs = [engine.submit(p, NEW, rid=f"r{i}", **kw)
            for i, p in enumerate(prompts)]
    engine.run_until_complete()
    return reqs


@pytest.fixture(scope="module")
def plain(models):
    """The streams of an engine that meets no fault."""
    return [r.tokens for r in _run(ServingEngine(
        models[1], ServingConfig(**BASE)), _prompts())]


# -- the registry -------------------------------------------------------------
PORT_POINTS = ("serving.decode_nan", "serving.prefill_nan",
               "serving.chunk_prefill_nan", "serving.kv_quant_nan",
               "serving.verify_nan", "serving.draft_divergence",
               "serving.callback_raise", "pool.bind_oom", "pool.evict_fail",
               "fleet.replica_die", "fleet.route_misroute",
               "scheduler.slow_step")


def test_points_are_the_jax_ones():
    assert sorted(faults.fault_points()) == sorted(PORT_POINTS)
    for name in PORT_POINTS:
        assert faults._POINTS[name].alias == jax_faults._POINTS[name].alias


@pytest.mark.parametrize("spec", [
    "decode_nan@3", "pool_oom:every=2", "pool.evict_fail:every=3:times=2",
    "verify_nan", "serving.callback_raise@2:times=1,bind_oom:every=4"])
def test_schedules_fire_as_jax(spec):
    """The same spec fires on the same hits in both harnesses, and the
    parsed params agree."""
    fires = []
    for f in (faults, jax_faults):
        with f.inject_spec(spec) as arms:
            seq = [[f.fault_point(n) is not None for n in sorted(arms)]
                   for _ in range(9)]
            fires.append((seq, {n: (a.at, a.every, a.times, a.params)
                                for n, a in arms.items()}))
    assert fires[0] == fires[1]


@pytest.mark.parametrize("spec,err", [
    ("decode_nan@x", ValueError), ("decode_nan@2:every=3", ValueError),
    ("decode_nan:oops", ValueError), ("decode_nan,decode_nan@2", ValueError),
    ("no_such_point", KeyError)])
def test_bad_specs_raise_as_jax(spec, err):
    for f in (faults, jax_faults):
        with pytest.raises(err):
            f.parse_spec(spec)


def test_module_spec_string_arms_and_counts(monkeypatch):
    faults.reset_stats()
    monkeypatch.setattr(faults, "FAULT_INJECT", "pool_oom@2")
    assert faults.stats()["armed"] == {"pool.bind_oom": repr(
        faults.Arm("pool.bind_oom", at=2))}
    faults.fire("pool.bind_oom")
    with pytest.raises(faults.FaultInjected) as e:
        faults.fire("bind_oom")
    assert e.value.point == "pool.bind_oom"
    # an inject() arm shadows the string's for its point
    with faults.inject("pool.bind_oom", every=1):
        with pytest.raises(faults.FaultInjected):
            faults.fire("pool.bind_oom")
    faults.fire("pool.bind_oom")
    assert faults.total_fired() == 2
    assert faults.stats()["fired"] == {"pool.bind_oom": 2}
    monkeypatch.setattr(faults, "FAULT_INJECT", "")
    faults.reset_stats()
    assert faults.total_fired() == 0 and faults.stats()["armed"] == {}


# -- the NaN sentinel against the JAX engine ----------------------------------
@pytest.mark.parametrize("point,kv", [
    ("serving.decode_nan", ""), ("serving.prefill_nan", ""),
    ("serving.chunk_prefill_nan", ""), ("serving.kv_quant_nan", "int8")])
def test_nan_sentinel_quarantines_one_request_as_jax(models, point, kv):
    jm, tm = models
    cfg = dict(BASE, kv_cache_dtype=kv)
    with jax_faults.inject(point, at=2):
        ref = _run(JaxServingEngine(jm, JaxServingConfig(interpret=True,
                                                         **cfg)), _prompts())
    eng = ServingEngine(tm, ServingConfig(**cfg))
    with faults.inject(point, at=2):
        ours = _run(eng, _prompts())
    assert [r.status for r in ours] == [r.status for r in ref]
    assert [r.tokens for r in ours] == [r.tokens for r in ref]
    bad = [r for r in ours if r.status == "error"]
    assert len(bad) == 1 and "NaN sentinel" in bad[0].error
    s = eng.drain()
    assert s["faults"]["nan_events"] == s["faults"]["quarantined_requests"] \
        == 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]


# -- the lifecycle ------------------------------------------------------------
def test_cancel_queued_and_running(models, plain):
    """r3 cancelled while queued never runs; r1 cancelled mid-decode ends
    ``cancelled`` with its blocks back; the others keep their streams."""
    eng = ServingEngine(models[1], ServingConfig(**dict(BASE, max_batch=2)))
    reqs = [eng.submit(p, NEW, rid=f"r{i}")
            for i, p in enumerate(_prompts())]
    reqs[3].cancel()
    for _ in range(6):
        eng.step()
    assert reqs[1].status == "running" and reqs[1].tokens
    reqs[1].cancel()
    eng.run_until_complete()
    assert [r.status for r in reqs] == ["finished", "cancelled", "finished",
                                        "cancelled"]
    assert reqs[3].error == "cancelled while queued" and not reqs[3].tokens
    assert reqs[1].error == "cancelled while running"
    assert reqs[1].tokens == plain[1][:len(reqs[1].tokens)]
    for i in (0, 2):
        assert reqs[i].tokens == plain[i]
    reqs[1].cancel()                       # a no-op once terminal
    s = eng.drain()
    assert s["scheduler"]["cancelled"] == 1
    assert s["faults"]["quarantined_requests"] == 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]


class _Clock:
    """A ``time`` module whose ``perf_counter`` only the test moves: the
    serving engine and scheduler read their deadlines through it, so what
    expires does not depend on the machine's load."""

    def __init__(self):
        self.t = 1000.0

    def perf_counter(self):
        return self.t

    def sleep(self, seconds):
        self.t += seconds

    def __getattr__(self, name):
        return getattr(time, name)


def test_deadlines_expire_queued_and_running(models, monkeypatch):
    """A request admitted and then past its deadline ends ``timeout`` at
    the next iteration boundary; one queued behind it (``max_batch=1``)
    ends ``timeout`` naming what blocked its admission. The engine's clock
    stands still until the test moves it past both deadlines: under load,
    a 1 ms deadline on the machine's clock could expire before the first
    admission had recorded why the request waits."""
    from paddle_tpu_torch.serving import engine as engine_mod
    from paddle_tpu_torch.serving import scheduler as scheduler_mod

    clock = _Clock()
    monkeypatch.setattr(engine_mod, "time", clock)
    monkeypatch.setattr(scheduler_mod, "time", clock)
    eng = ServingEngine(models[1], ServingConfig(**dict(BASE, max_batch=1)))
    p = _prompts()
    slow = eng.submit(p[0], NEW, deadline_ms=60)
    queued = eng.submit(p[2], NEW, deadline_ms=1)
    eng.step()                                   # slow admitted
    assert slow.status == "running" and queued.status == "queued"
    clock.sleep(0.07)
    eng.run_until_complete()
    # reaped at the iteration boundary, before its next decode step
    assert slow.status == "timeout" and "ms expired" in slow.error
    assert "generated token(s)" in slow.error
    assert queued.status == "timeout"
    assert "while queued (admission blocked: no_free_slot)" in queued.error
    s = eng.drain()
    assert s["scheduler"]["deadline_timeouts"] == 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]
    with pytest.raises(ValueError, match="deadline_ms"):
        eng.submit(p[0], NEW, deadline_ms=0)


def test_slow_step_expires_a_queued_deadline_as_jax(models):
    """``scheduler.slow_step`` sleeps at the head of admission: a request
    whose deadline passes meanwhile ends ``timeout`` before it is ever
    admitted, in the port as in JAX."""
    jm, tm = models
    got = []
    for f, eng in ((jax_faults, JaxServingEngine(jm, JaxServingConfig(
            interpret=True, **BASE))),
            (faults, ServingEngine(tm, ServingConfig(**BASE)))):
        req = eng.submit(_prompts()[0], NEW, deadline_ms=20)
        with f.inject("scheduler.slow_step", at=1, seconds=0.05):
            eng.step()
        got.append((req.status, req.error, req.tokens,
                    eng.scheduler.stats()["deadline_timeouts"]))
        eng.drain()
    assert got[0] == got[1]
    assert got[1][0] == "timeout" and "expired while queued" in got[1][1]


@pytest.mark.parametrize("how", ["callback", "serving.callback_raise"])
def test_raising_callback_is_contained(models, plain, how):
    def on_token(req, tok, last):
        if how == "callback" and len(req.tokens) == 3:
            raise ValueError("user code")

    eng = ServingEngine(models[1], ServingConfig(**BASE))
    with faults.inject("serving.callback_raise",
                       at=3 if how != "callback" else 10**6):
        reqs = _run(eng, _prompts(), on_token=on_token)
    assert [r.tokens for r in reqs] == plain
    errs = [e for r in reqs for e in r.callback_errors]
    assert len(errs) == (len(reqs) if how == "callback" else 1)
    assert errs[0].startswith("ValueError" if how == "callback"
                              else "FaultInjected")
    assert eng.stats()["faults"]["callback_errors"] == len(errs)


def test_prefill_that_raises_quarantines_its_request(models, plain,
                                                     monkeypatch):
    """A prefill chunk that raises ends its own request ``error``; the
    others keep their streams and the pool drains."""
    eng = ServingEngine(models[1], ServingConfig(**BASE))
    prefill = eng._prefill

    def failing(ids, chunk, offset, row):
        if offset == 16:                     # r1's second chunk
            raise RuntimeError("kernel fault")
        return prefill(ids, chunk, offset, row)

    monkeypatch.setattr(eng, "_prefill", failing)
    reqs = _run(eng, _prompts())
    assert [r.status for r in reqs] == ["finished", "error", "finished",
                                        "finished"]
    assert reqs[1].error == "prefill failed: RuntimeError: kernel fault"
    assert [reqs[i].tokens for i in (0, 2, 3)] == [plain[i]
                                                   for i in (0, 2, 3)]
    s = eng.drain()
    assert s["faults"]["contained"] == s["faults"]["quarantined_requests"] \
        == 1
    assert s["pool"]["free_blocks"] == s["pool"]["num_blocks"]


def test_evacuate_and_resume_elsewhere(models, plain):
    """Requests taken from a lost engine mid-stream finish on another from
    ``resume_tokens`` with the streams they would have had."""
    tm = models[1]
    a = ServingEngine(tm, ServingConfig(**dict(BASE, max_batch=2)))
    reqs = [a.submit(p, NEW, rid=f"r{i}") for i, p in enumerate(_prompts())]
    for _ in range(5):
        a.step()
    running, queued = a.evacuate()
    assert a.health()["draining"] and len(running) == 2 and len(queued) == 2
    assert all(r.status == "running" and r.tokens for r in running)
    with pytest.raises(RuntimeError, match="draining"):
        a.submit(_prompts()[0], NEW)
    b = ServingEngine(tm, ServingConfig(**BASE))
    for r in reversed(running):            # the first admitted at the head
        b.scheduler.requeue_front(r)
    for r in queued:
        b.scheduler.adopt(r)
    b.run_until_complete()
    assert [r.tokens for r in reqs] == plain
    assert b.scheduler.stats()["submitted"] == 0
    b.drain()


def test_drain_keeps_queue_on_request(models):
    eng = ServingEngine(models[1], ServingConfig(**dict(BASE, max_batch=1)))
    reqs = [eng.submit(p, 3) for p in _prompts()[:3]]
    eng.step()
    eng.drain(cancel_queued=False)
    assert reqs[0].status == "finished"
    assert [r.status for r in reqs[1:]] == ["queued", "queued"]
    h = eng.health()
    assert h["queued"] == 2 and not h["draining"]
    jkeys = {"engine", "draining", "iterations", "active", "prefilling",
             "queued", "quarantined", "contained", "postmortems",
             "kv_cache_dtype", "speculative_k"}
    assert set(h) == jkeys
    eng.run_until_complete()
    assert all(r.status == "finished" for r in reqs)
