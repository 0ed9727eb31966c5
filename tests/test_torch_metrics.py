"""The port's metrics registry (``paddle_tpu_torch/core/metrics.py``) against
the JAX package's ``paddle_tpu/core/metrics.py`` on the CPU: the same
instruments fed the same seeded values give the same snapshots,
percentiles, Prometheus bytes and JSON; reset, clear, the off switch, the
pruning of dead owners and the ``faults.injected`` mirror behave alike.
Then the serving surface: the port engine's histograms against its raw
latency lists, ``stats()`` against the registry, the router-facing gauges
under the engine's label, a dead engine's children pruned, and tokens
unchanged with telemetry off (a tiny f32 Llama loaded from the JAX model
through ``load_paddle_tpu_state``).
"""

import gc
import json

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.core import metrics as jax_metrics
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.core import faults, metrics
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.kv_cache import KVCacheSpec
from paddle_tpu_torch.serving import BlockPool, ServingConfig, ServingEngine
from paddle_tpu_torch.serving.scheduler import Request

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
BASE = dict(max_seq_len=64, block_size=8, prefill_buckets=(16,),
            max_batch=4, prefill_token_budget=16)
BOTH = pytest.mark.parametrize("m", [metrics, jax_metrics],
                               ids=["port", "jax"])


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _prompts(lens=(5, 30, 13, 9, 17)):
    rng = np.random.RandomState(17)
    return [rng.randint(0, 256, (n,)).astype(np.int32) for n in lens]


class _jax_off:
    """The JAX switch, set off for a block."""

    def __enter__(self):
        paddle.set_flags({"metrics": False})

    def __exit__(self, *exc):
        paddle.set_flags({"metrics": True})


def _off(m):
    if m is jax_metrics:
        return _jax_off()
    return _port_off()


class _port_off:
    def __enter__(self):
        self.old = metrics.set_enabled(False)

    def __exit__(self, *exc):
        metrics.set_enabled(self.old)


def _populated(m):
    """The JAX golden test's registry, plus a seeded histogram."""
    r = m.Registry()
    r.counter("serving.preemptions", doc="evictions", engine="0").inc(3)
    r.counter("serving.preemptions", engine="1").inc(1)
    r.gauge("pool.free", doc="free blocks").set(12)
    h = r.histogram("ttft.ms", doc="ttft", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    g = r.gauge("depth", engine="0", reason='a"b\\c')
    g.set(4)
    g.inc()
    g.dec(2)
    r.gauge("peak").set_to_max(5)
    r.gauge("peak").set_to_max(3)
    r.counter("frac").inc(0.25)
    hh = r.histogram("ms", engine="0")
    rng = np.random.RandomState(0)
    for v in np.concatenate([rng.uniform(0.5, 20.0, 400),
                             rng.uniform(50.0, 400.0, 100)]):
        hh.observe(float(v))
    return r


# -- the instruments ----------------------------------------------------------------
def test_snapshot_json_and_prometheus_match_jax():
    """The same registrations and values: equal snapshots, equal strict
    JSON and byte-identical Prometheus text (labels escaped alike)."""
    ours, ref = _populated(metrics), _populated(jax_metrics)
    assert ours.snapshot() == ref.snapshot()
    assert ours.to_prometheus() == ref.to_prometheus()
    assert ours.to_json(indent=1) == ref.to_json(indent=1)
    decoded = json.loads(ours.to_json())
    assert decoded["histograms"]["ttft.ms"][""]["buckets"][-1][0] == "+Inf"
    assert decoded["counters"]["serving.preemptions"]["engine=0"] == 3


def test_prometheus_golden_output():
    r = metrics.Registry()
    r.counter("serving.preemptions", doc="evictions", engine="0").inc(3)
    r.counter("serving.preemptions", engine="1").inc(1)
    r.gauge("pool.free", doc="free blocks").set(12)
    h = r.histogram("ttft.ms", doc="ttft", buckets=(1.0, 10.0, 100.0))
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    assert r.to_prometheus() == """\
# HELP pool_free free blocks
# TYPE pool_free gauge
pool_free 12
# HELP serving_preemptions evictions
# TYPE serving_preemptions counter
serving_preemptions{engine="0"} 3
serving_preemptions{engine="1"} 1
# HELP ttft_ms ttft
# TYPE ttft_ms histogram
ttft_ms_bucket{le="1"} 1
ttft_ms_bucket{le="10"} 2
ttft_ms_bucket{le="100"} 3
ttft_ms_bucket{le="+Inf"} 4
ttft_ms_sum 555.5
ttft_ms_count 4
"""


def test_percentiles_match_jax_and_numpy():
    """The same estimate as JAX's at every percentile, within one bucket
    width of numpy's, on the default and the ratio buckets."""
    rng = np.random.RandomState(3)
    for bounds, vals in ((None, np.concatenate([
            rng.uniform(0.5, 20.0, 400), rng.lognormal(4.0, 1.0, 100)])),
            (metrics.RATIO_BUCKETS, rng.uniform(0.0, 1.0, 300))):
        assert metrics.RATIO_BUCKETS == jax_metrics.RATIO_BUCKETS
        assert metrics.DEFAULT_MS_BUCKETS == jax_metrics.DEFAULT_MS_BUCKETS
        hs = [m.Registry().histogram("h", buckets=bounds)
              for m in (metrics, jax_metrics)]
        for v in vals:
            for h in hs:
                h.observe(float(v))
        for p in (0, 1, 25, 50, 90, 99, 100):
            est = hs[0].percentile(p)
            assert est == hs[1].percentile(p), p
            exact = float(np.percentile(vals, p))
            lo, hi = hs[0].bucket_bounds(exact)
            assert abs(est - exact) <= hi - lo, (p, exact, est)
        assert hs[0].state() == hs[1].state()


@BOTH
def test_histogram_edges(m):
    r = m.Registry()
    h = r.histogram("e", buckets=(1.0, 2.0))
    assert h.percentile(50) is None
    h.observe(10.0)                               # the overflow bucket
    assert h.percentile(50) == 10.0
    h2 = r.histogram("one", buckets=(4.0, 8.0))
    h2.observe(3.0)
    assert h2.percentile(50) == 3.0               # clamped to the max
    h3 = r.histogram("c", buckets=(1.0, 2.0, 4.0, 8.0))
    for v in (0.5, 1.5, 3.0, 3.5, 9.0):
        h3.observe(v)
    assert [c for _, c in h3.state()["buckets"]] == [1, 1, 2, 0, 1]
    assert (h3.count, h3.sum, h3.min, h3.max) == (5, 17.5, 0.5, 9.0)


@BOTH
@pytest.mark.parametrize("case", ["counter_then_gauge",
                                  "counter_then_histogram", "bad_bounds",
                                  "fixed_bounds", "negative_inc"])
def test_refusals_match_jax(m, case):
    r = m.Registry()
    if case == "counter_then_gauge":
        r.counter("x")
        with pytest.raises(TypeError):
            r.gauge("x")
    elif case == "counter_then_histogram":
        r.counter("x")
        with pytest.raises(TypeError):
            r.histogram("x")
    elif case == "bad_bounds":
        with pytest.raises(ValueError):
            r.histogram("bad", buckets=(2.0, 1.0))
    elif case == "fixed_bounds":
        r.histogram("fixed", buckets=(1.0, 2.0))
        with pytest.raises(ValueError):
            r.histogram("fixed", buckets=(1.0, 4.0))
    else:
        with pytest.raises(ValueError):
            r.counter("c").inc(-1)
        with _off(m), pytest.raises(ValueError):
            r.counter("c").inc(-1)


def test_same_label_set_is_the_same_child_and_label_keys_match_jax():
    r = metrics.Registry()
    assert r.counter("reqs", engine="0") is r.counter("reqs", engine="0")
    assert r.histogram("h", a="1") is r.histogram("h", a="1")
    for labels in ({}, {"engine": "3"}, {"b": "2", "a": "1"},
                   {"reason": 'x"y\\z'}):
        assert metrics.label_key(**labels) == \
            jax_metrics.label_key(**labels)
        key = metrics.label_key(**labels)
        assert metrics._prom_labels(key) == jax_metrics._prom_labels(key)


@BOTH
def test_snapshot_is_a_fresh_copy(m):
    r = _populated(m)
    snap = r.snapshot()
    snap["counters"]["serving.preemptions"]["engine=0"] = 999
    snap["histograms"]["ttft.ms"][""]["buckets"][0][1] = 999
    snap["gauges"].clear()
    fresh = r.snapshot()
    assert fresh["counters"]["serving.preemptions"]["engine=0"] == 3
    assert fresh["histograms"]["ttft.ms"][""]["buckets"][0][1] == 1
    assert fresh["gauges"]["pool.free"] == {"": 12}


def test_reset_and_clear_match_jax():
    ours, ref = _populated(metrics), _populated(jax_metrics)
    ours.reset()
    ref.reset()
    snap = ours.snapshot()
    assert snap == ref.snapshot()
    assert snap["counters"]["serving.preemptions"] == {"engine=0": 0,
                                                       "engine=1": 0}
    assert snap["histograms"]["ttft.ms"][""]["count"] == 0
    assert ours.to_prometheus() == ref.to_prometheus()
    held = ours.counter("serving.preemptions", engine="0")
    ours.clear()
    held.inc()                                  # still works, detached
    assert ours.snapshot() == {"counters": {}, "gauges": {},
                               "histograms": {}}
    assert ours.to_prometheus() == ""


@BOTH
def test_off_switch_makes_mutations_noops(m):
    r = m.Registry()
    c, g = r.counter("c"), r.gauge("g")
    h = r.histogram("h", buckets=(1.0, 2.0))
    with _off(m):
        assert m.enabled() is False
        c.inc(5)
        g.set(9)
        g.inc(2)
        g.set_to_max(9)
        h.observe(1.5)
        assert c.value == 0 and g.value == 0 and h.count == 0
    assert m.enabled() is True
    c.inc()
    assert c.value == 1


def test_off_switch_suppresses_request_traces():
    with _port_off():
        req = Request("r0", np.arange(4, dtype=np.int32), 2)
        req._trace("admitted", slot=0)
        assert req.trace_events == [] and req._trace("x") is None
    req = Request("r1", np.arange(4, dtype=np.int32), 2)
    ev = req.trace_events
    assert [e["event"] for e in ev] == ["queued"] and ev[0]["prompt_len"] == 4
    assert metrics.set_enabled(True) is True


@BOTH
def test_dead_owners_are_pruned(m):
    r = m.Registry()

    class Pool:
        free = 7

    pool = Pool()
    r.gauge("free", callback=lambda p: p.free, owner=pool, engine="0")
    r.counter("n", owner=pool, engine="0").inc(2)
    r.histogram("h", owner=pool, engine="0").observe(1.0)
    assert r.snapshot()["gauges"]["free"]["engine=0"] == 7
    pool.free = 9
    assert r.snapshot()["gauges"]["free"]["engine=0"] == 9
    del pool
    gc.collect()
    assert r.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert r.children("free") == {} and r.children("nothing") == {}


@pytest.mark.parametrize("point", ["serving.prefill_nan", "pool.bind_oom",
                                   "fleet.replica_die"])
def test_fault_fires_mirror_into_registry_as_jax(point):
    """Every fire counts one in ``faults.injected{point=...}``, in the port
    as in JAX; ``reset_stats`` zeroes both the ledger and the mirror."""
    key = metrics.label_key(point=point)
    got = []
    for f, m in ((faults, metrics), (jax_faults, jax_metrics)):
        f.reset_stats()
        with f.inject(point, every=2):
            for _ in range(5):
                f.fault_point(point)
        got.append((f.total_fired(),
                    m.snapshot()["counters"]["faults.injected"][key]))
        f.reset_stats()
        assert m.snapshot()["counters"]["faults.injected"][key] == 0
    assert got[0] == got[1] == (2, 2)


# -- the serving surface ------------------------------------------------------------
def _engine(tm, **kw):
    return ServingEngine(tm, ServingConfig(**dict(BASE, **kw)))


def test_engine_histograms_agree_with_raw_lists(models):
    eng = _engine(models[1])
    eng.generate_batch(_prompts(), max_new_tokens=6)
    s = eng.stats()["latency"]
    assert len(eng._ttft_ms) == 5 and eng._m_ttft.count == 5
    for raw, h, name in ((eng._ttft_ms, eng._m_ttft, "ttft"),
                         (eng._decode_ms, eng._m_tpot, "tpot")):
        assert h.sum == pytest.approx(sum(raw))
        for p in (50, 90, 99):
            exact = float(np.percentile(raw, p))
            lo, hi = h.bucket_bounds(exact)
            assert abs(s[f"{name}_p{p}_ms"] - exact) <= hi - lo
    assert eng._m_step_ms.count == eng.iterations
    assert s["step_p50_ms"] <= s["step_p99_ms"]


def test_stats_keys_match_jax(models):
    """``stats()`` has the JAX latency, flight-recorder and fault keys; the
    port adds its launch counts and drops what it has no counterpart for
    (trace counts, kernel fallbacks)."""
    jm, tm = models
    jeng = JaxServingEngine(jm, JaxServingConfig(interpret=True, **BASE))
    eng = _engine(tm)
    for e in (jeng, eng):
        e.generate_batch(_prompts()[:2], max_new_tokens=3)
    js, s = jeng.stats(), eng.stats()
    assert set(s["latency"]) == set(js["latency"])
    assert set(s["flight_recorder"]) == set(js["flight_recorder"])
    assert s["flight_recorder"]["records"] == eng.iterations
    assert set(js) - set(s) == {"trace_counts"}
    assert set(js["faults"]) - set(s["faults"]) == {"fallback_activations"}
    assert set(eng.health()) == set(jeng.health())


def test_stats_views_match_registry(models):
    """Every scheduler, engine and pool count of ``stats()`` is the number
    its registry child holds, under the engine's label."""
    eng = _engine(models[1], max_batch=1)
    a = eng.submit(np.arange(6, dtype=np.int32), 3, rid="a")
    b = eng.submit(np.arange(6, dtype=np.int32) + 1, 3, rid="b")
    eng.run_until_complete()
    assert a.finished and b.finished
    s = eng.stats()
    snap = metrics.snapshot()
    lk = metrics.label_key(**eng.metrics_labels)
    c = lambda name: snap["counters"][name][lk]  # noqa: E731
    q = s["scheduler"]
    assert q["submitted"] == c("serving.submitted") == 2
    assert q["admitted"] == c("serving.admitted") == 2
    assert q["finished"] == c("serving.finished") == 2
    bp = q["backpressure_events"]
    assert bp == c("serving.backpressure_events") >= 1
    assert q["rejected_reasons"] == {"no_free_slot": bp}
    assert snap["counters"]["serving.admission_rejected"][
        metrics.label_key(reason="no_free_slot", **eng.metrics_labels)] == bp
    assert s["prefill_chunks"] == c("serving.prefill_chunks")
    assert s["preemptions"] == c("serving.preemptions") == 0
    assert s["peak_running"] == snap["gauges"]["serving.peak_running"][lk]
    assert q["peak_queue_depth"] == \
        snap["gauges"]["serving.peak_queue_depth"][lk] == 2
    p = s["pool"]
    for key in ("free_blocks", "num_blocks", "blocks_in_use",
                "cached_blocks", "evictable_blocks", "prefix_hit_rate",
                "peak_blocks_in_use", "utilization", "bytes_per_block"):
        assert p[key] == snap["gauges"][f"serving.pool.{key}"][lk], key
    for key in ("prefix_queries", "prefix_hit_blocks", "prefix_miss_blocks",
                "prefix_saved_tokens", "cache_evictions"):
        assert p[key] == snap["counters"][f"serving.pool.{key}"][lk], key
    assert snap["histograms"]["serving.ttft_ms"][lk]["count"] == 2


def test_router_facing_snapshot_under_one_label(models):
    eng = _engine(models[1])
    eng.generate_batch(_prompts()[:2], max_new_tokens=4)
    snap = metrics.snapshot()
    lk = metrics.label_key(**eng.metrics_labels)
    for name in ("serving.pool.free_blocks", "serving.pool.evictable_blocks",
                 "serving.pool.prefix_hit_rate", "serving.queue_depth",
                 "serving.active", "serving.prefilling",
                 "serving.iterations"):
        assert lk in snap["gauges"][name], name
    for name in ("serving.decode_stalls", "serving.preemptions",
                 "serving.admitted", "serving.finished",
                 "serving.quarantined_requests", "serving.contained_faults"):
        assert lk in snap["counters"][name], name
    for name in ("serving.ttft_ms", "serving.tpot_ms", "serving.step_ms"):
        assert snap["histograms"][name][lk]["count"] >= 1, name
    assert snap["gauges"]["serving.iterations"][lk] == eng.iterations
    assert "serving.spec_drafted" not in snap["counters"] or \
        lk not in snap["counters"]["serving.spec_drafted"]


def test_speculative_counters_mirror_stats(models):
    tm = models[1]
    eng = _engine(tm, speculative=(tm, 3))
    eng.generate_batch(_prompts()[:3], max_new_tokens=8)
    sp = eng.stats()["speculative"]
    snap = metrics.snapshot()
    lk = metrics.label_key(**eng.metrics_labels)
    assert sp["drafted_tokens"] == snap["counters"]["serving.spec_drafted"][lk]
    assert sp["accepted_tokens"] == \
        snap["counters"]["serving.spec_accepted"][lk] > 0
    assert sp["rollback_tokens"] == \
        snap["counters"]["serving.spec_rollback_tokens"][lk]
    h = snap["histograms"]["serving.spec_accept_rate"][lk]
    assert h["count"] == sp["drafted_tokens"] // 3
    assert [b for b, _ in h["buckets"][:-1]] == list(metrics.RATIO_BUCKETS)


def test_dead_engine_children_pruned(models):
    eng = _engine(models[1])
    eng.generate_batch([np.arange(5, dtype=np.int32)], max_new_tokens=2)
    lk = metrics.label_key(**eng.metrics_labels)
    assert lk in metrics.snapshot()["counters"]["serving.finished"]
    del eng
    gc.collect()
    snap = metrics.snapshot()
    for kind, name in (("counters", "serving.finished"),
                       ("histograms", "serving.ttft_ms"),
                       ("gauges", "serving.peak_running"),
                       ("gauges", "serving.queue_depth"),
                       ("gauges", "serving.pool.free_blocks")):
        assert lk not in snap[kind].get(name, {}), (kind, name)


def test_standalone_pool_gets_own_label():
    spec = KVCacheSpec(num_layers=1, num_kv_heads=1, head_dim=8,
                       page_size=4)
    pool = BlockPool(spec, max_seq_len=16, num_blocks=5, max_slots=2)
    assert pool.metrics_labels["engine"].startswith("pool-")
    lk = metrics.label_key(**pool.metrics_labels)
    assert metrics.snapshot()["gauges"]["serving.pool.free_blocks"][lk] == 4


def test_telemetry_off_changes_no_token_and_no_count(models):
    """Off, the engine serves the same tokens with the same plain counts,
    its registry children stay at zero and no request records an event;
    the flight recorder's ring still fills."""
    tm = models[1]
    cfg = dict(max_batch=4, num_blocks=7)       # preemption and stalls
    on = _engine(tm, **cfg)
    ref = [on.submit(p, 8) for p in _prompts()]
    on.run_until_complete()
    with _port_off():
        off = _engine(tm, **cfg)
        reqs = [off.submit(p, 8) for p in _prompts()]
        off.run_until_complete()
    assert [r.tokens for r in reqs] == [r.tokens for r in ref]
    assert all(r.trace_events == [] for r in reqs)
    assert all(r.trace_events for r in ref)
    s_on, s_off = on.stats(), off.stats()
    for key in ("iterations", "preemptions", "prefill_chunks",
                "decode_steps", "peak_running", "decode_stalls"):
        assert s_on[key] == s_off[key], key
    assert s_on["preemptions"] > 0
    assert s_on["scheduler"] == s_off["scheduler"]
    lk = metrics.label_key(**off.metrics_labels)
    snap = metrics.snapshot()
    assert snap["counters"]["serving.finished"][lk] == 0
    assert snap["counters"]["serving.preemptions"][lk] == 0
    assert snap["histograms"]["serving.step_ms"][lk]["count"] == 0
    assert len(off.flight_recorder) == off.iterations
