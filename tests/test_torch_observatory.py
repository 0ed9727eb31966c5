"""The port's flight recorder, scrape surface and request trace events on
the CPU: ``paddle_tpu_torch/core/observatory.py``'s ring and postmortems
(on a quarantine, a contained fault, with the ring off, written as JSON),
the engine's step records and every request's lifecycle events against
the JAX engine's (``interpret=True``) on the same schedule, ``/metrics``
and ``/healthz`` of ``metrics.serve()`` over loopback, and
``tools/trace_requests.py``'s Chrome trace against the JAX tool's
functions on the same events. The tiny f32 Llama is loaded from the JAX
model through ``load_paddle_tpu_state``.
"""

import importlib.util
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core import faults as jax_faults
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu_torch.core import faults, metrics, observatory
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.serving import ServingConfig, ServingEngine
from paddle_tpu_torch.tools import trace_requests

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
BASE = dict(max_seq_len=64, block_size=8, prefill_buckets=(16,),
            max_batch=4, prefill_token_budget=16)
# a pool small enough to preempt and stall
TIGHT = dict(BASE, num_blocks=7)
RECORD_KEYS = ("iteration", "active", "prefilling", "queued", "decode_batch",
               "prefill_tokens", "stalls", "nonfinite_health",
               "preemptions_total", "quarantined_total", "contained_total",
               "injected_total")


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


def _engine(tm, **kw):
    return ServingEngine(tm, ServingConfig(**dict(BASE, **kw)))


def _run(engine, prompts, new):
    reqs = [engine.submit(p, new, rid=f"r{i}") for i, p in enumerate(prompts)]
    engine.run_until_complete()
    return reqs


def _jax_pair(models, fault=None, spec=False, **kw):
    """The JAX and the port engine over one schedule, with ``fault`` =
    ``(point, at)`` armed in each harness; both ledgers start at 0."""
    jm, tm = models
    out = []
    for f, eng in ((jax_faults, JaxServingEngine(jm, JaxServingConfig(
            interpret=True, speculative=(jm, 3) if spec else None,
            **dict(TIGHT, **kw)))),
            (faults, _engine(tm, speculative=(tm, 3) if spec else None,
                             **dict(TIGHT, **kw)))):
        f.reset_stats()
        if fault is None:
            reqs = _run(eng, _prompts(), 8)
        else:
            with f.inject(fault[0], at=fault[1]):
                reqs = _run(eng, _prompts(), 8)
        out.append((eng, reqs))
    return out


def _events(req):
    """A request's events without their timestamps."""
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in req.trace_events]


# -- the ring and the postmortems ---------------------------------------------------
def test_ring_is_bounded(models, monkeypatch):
    monkeypatch.setattr(observatory, "SERVING_FLIGHT_RECORDER_LEN", 4)
    eng = _engine(models[1])
    eng.submit(np.arange(5, dtype=np.int32), 8)
    eng.run_until_complete()
    assert eng.iterations > 4 and len(eng.flight_recorder) == 4
    assert [r["iteration"] for r in eng.flight_recorder.records()] == \
        list(range(eng.iterations - 3, eng.iterations + 1))
    assert eng.stats()["flight_recorder"] == {"records": 4, "ring": 4,
                                              "dumps": 0}


def test_ring_off_keeps_the_step_histogram(models, monkeypatch):
    monkeypatch.setattr(observatory, "SERVING_FLIGHT_RECORDER_LEN", 0)
    eng = _engine(models[1])
    eng.submit(np.arange(5, dtype=np.int32), 3)
    eng.run_until_complete()
    assert len(eng.flight_recorder) == 0
    assert eng.flight_recorder.record(x=1) is None
    assert eng.stats()["latency"]["step_p50_ms"] is not None


def test_quarantine_dumps_a_coherent_postmortem(models, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(observatory, "SERVING_POSTMORTEM_DIR", str(tmp_path))
    eng = _engine(models[1])
    faults.reset_stats()
    with faults.inject("serving.decode_nan", at=2):
        reqs = [eng.submit(np.arange(5, dtype=np.int32) + i, 5)
                for i in range(3)]
        eng.run_until_complete()
    assert sum(r.status == "error" for r in reqs) == 1
    fr = eng.flight_recorder
    pm = fr.postmortems[-1]
    assert fr.dumps == 1 and pm["reason"] == "quarantine"
    assert pm["context"]["last_quarantine"]["status"] == "error"
    assert pm["labels"] == eng.metrics_labels
    last = pm["records"][-1]
    assert last["quarantined_total"] == 1 == \
        pm["metrics"]["counters"]["serving.quarantined_requests"]
    assert pm["metrics"]["counters"]["serving.nan_events"] == 1
    assert last["injected_total"] == sum(pm["fault_ledger"].values()) == 1
    assert last["nonfinite_health"] == 1
    loaded = json.loads(open(pm["path"]).read())
    assert loaded["reason"] == "quarantine"
    assert loaded["records"][-1]["iteration"] == last["iteration"]
    assert eng.health()["postmortems"] == 1


def test_contained_fault_without_quarantine_dumps(models):
    eng = _engine(models[1])
    with faults.inject("pool.bind_oom", at=1):
        req = eng.submit(np.arange(5, dtype=np.int32), 3)
        eng.run_until_complete()
    assert req.status == "finished"
    assert eng.flight_recorder.postmortems[-1]["reason"] == "contained_fault"
    assert eng.flight_recorder.postmortems[-1]["context"][
        "contained_this_step"] == 1


def test_ring_off_still_dumps_on_quarantine(models, monkeypatch):
    monkeypatch.setattr(observatory, "SERVING_FLIGHT_RECORDER_LEN", 0)
    eng = _engine(models[1])
    with faults.inject("serving.decode_nan", at=2):
        reqs = [eng.submit(np.arange(5, dtype=np.int32) + i, 5)
                for i in range(2)]
        eng.run_until_complete()
    assert any(r.status == "error" for r in reqs)
    pm = eng.flight_recorder.postmortems[-1]
    assert pm["records"] == []
    assert pm["metrics"]["counters"]["serving.quarantined_requests"] == 1


def test_telemetry_off_still_dumps_on_quarantine(models):
    """The dump triggers are plain counts: with telemetry off a quarantine
    still dumps."""
    eng = _engine(models[1])
    old = metrics.set_enabled(False)
    try:
        with faults.inject("serving.decode_nan", at=2):
            reqs = [eng.submit(np.arange(5, dtype=np.int32) + i, 5)
                    for i in range(2)]
            eng.run_until_complete()
    finally:
        metrics.set_enabled(old)
    assert any(r.status == "error" for r in reqs)
    assert eng.flight_recorder.dumps == 1


def test_postmortems_are_capped_and_an_unwritable_dir_is_recorded(
        tmp_path, monkeypatch):
    blocker = tmp_path / "file"
    blocker.write_text("")
    monkeypatch.setattr(observatory, "SERVING_POSTMORTEM_DIR",
                        str(blocker / "sub"))
    fr = observatory.FlightRecorder(maxlen=2, labels={"engine": "x"})
    for i in range(observatory.FlightRecorder.MAX_POSTMORTEMS + 3):
        fr.record(iteration=i)
        doc = fr.dump("test", i=i)
    assert len(fr.postmortems) == fr.MAX_POSTMORTEMS
    assert fr.postmortems[0]["context"]["i"] == 3
    assert "path_error" in doc and "path" not in doc
    assert [r["iteration"] for r in doc["records"]] == [fr.dumps - 2,
                                                        fr.dumps - 1]


def test_drain_leak_dumps_before_raising(models):
    eng = _engine(models[1])
    eng.submit(np.arange(5, dtype=np.int32), 3)
    eng.run_until_complete()
    eng.pool._free_blocks.pop()                 # a block goes missing
    with pytest.raises(RuntimeError, match="did not reclaim"):
        eng.drain()
    pm = eng.flight_recorder.postmortems[-1]
    assert pm["reason"] == "drain_leak"
    assert pm["context"]["free_blocks"] == pm["context"]["num_blocks"] - 1


# -- against the JAX engine ----------------------------------------------------------
@pytest.mark.parametrize("fault", [None, ("serving.decode_nan", 4)],
                         ids=["plain", "decode_nan"])
def test_step_records_match_jax(models, fault):
    """Every step record's occupancy, prefill tokens, stalls and cumulative
    counts equal the JAX engine's on the same schedule (a pool that
    preempts and stalls; a quarantine); the health extrema within f32
    rounding. ``step_ms`` is the host clock and is not compared."""
    (jeng, jreqs), (eng, reqs) = _jax_pair(models, fault)
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    jrec, rec = jeng.flight_recorder.records(), eng.flight_recorder.records()
    assert len(rec) == len(jrec) == eng.iterations
    for a, b in zip(rec, jrec):
        assert {k: a[k] for k in RECORD_KEYS} == {k: b[k] for k in RECORD_KEYS}
        for k in ("health_min", "health_max"):
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None:
                assert a[k] == pytest.approx(b[k], rel=1e-4, abs=1e-5), k
    if fault is None:
        assert max(r["preemptions_total"] for r in rec) > 0
        assert max(r["stalls"] for r in rec) > 0
    else:
        assert rec[-1]["quarantined_total"] == 1
    pm, jpm = eng.flight_recorder.postmortems, jeng.flight_recorder.postmortems
    assert [(p["reason"], p["context"]["iteration"]) for p in pm] == \
        [(p["reason"], p["context"]["iteration"]) for p in jpm]
    assert len(pm) == (fault is not None)


@pytest.mark.parametrize("spec,fault", [
    (False, None), (False, ("serving.decode_nan", 4)),
    (False, ("pool.bind_oom", 9)), (True, ("serving.verify_nan", 2))],
    ids=["preempt", "decode_nan", "bind_oom", "speculative"])
def test_request_trace_events_match_jax(models, spec, fault):
    """Every request's lifecycle events (names and every attribute but the
    timestamp: queued, admitted / recompute with its slot and cached
    prefix, prefill chunks, decode iterations, preempt, requeue, draft /
    verify / accept, quarantine, the terminal status) equal the JAX
    engine's."""
    (jeng, jreqs), (eng, reqs) = _jax_pair(models, fault, spec=spec)
    names = set()
    for r, j in zip(reqs, jreqs):
        assert r.tokens == j.tokens and r.status == j.status
        assert _events(r) == _events(j), r.rid
        names |= {e["event"] for e in r.trace_events}
    want = {"queued", "admitted", "prefill_chunk", "finished"}
    want |= {"draft", "verify", "accept"} if spec else {"decode"}
    want |= {"quarantine", "error"} if fault and "nan" in fault[0] else set()
    want |= {"preempt", "requeue", "recompute"} if fault is None else set()
    assert want <= names, want - names
    ts = [e["ts"] for r in reqs for e in r.trace_events]
    assert all(np.isfinite(ts))


# -- the scrape surface -------------------------------------------------------------
def _parse_prometheus(text):
    """``{series: value}`` and the TYPE map of a text exposition."""
    series, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            series[key] = float("inf") if val == "+Inf" else float(val)
    return series, types


def _get(url):
    return urllib.request.urlopen(url, timeout=10).read().decode()


def test_metrics_and_healthz_round_trip_a_live_engine(models):
    eng = _engine(models[1])
    _run(eng, _prompts()[:2], 4)
    lk = metrics.label_key(**eng.metrics_labels)
    srv = metrics.serve()
    try:
        assert srv.host == "127.0.0.1"
        series, types = _parse_prometheus(_get(srv.url + "/metrics"))
        doc = json.loads(_get(srv.url + "/healthz"))
    finally:
        srv.close()
    snap = metrics.snapshot()
    lbl = ",".join(f'{k}="{v}"' for k, v in sorted(eng.metrics_labels.items()))
    assert series[f"serving_finished{{{lbl}}}"] == \
        snap["counters"]["serving.finished"][lk] == 2
    assert types["serving_finished"] == "counter"
    assert types["serving_step_ms"] == "histogram"
    assert types["serving_pool_free_blocks"] == "gauge"
    count = series[f"serving_step_ms_count{{{lbl}}}"]
    assert count == snap["histograms"]["serving.step_ms"][lk]["count"]
    buckets = [v for k, v in series.items()
               if k.startswith(f"serving_step_ms_bucket{{{lbl}")]
    assert buckets == sorted(buckets) and buckets[-1] == count
    assert doc["status"] == "ok" and doc["draining"] is False
    mine = [e for e in doc["serving"]["engines"]
            if e["engine"] == eng.metrics_labels["engine"]]
    assert len(mine) == 1 and mine[0]["iterations"] == eng.iterations
    assert mine[0]["postmortems"] == 0
    assert set(doc["serving"]["faults"]) == {"fired", "total_fired", "armed"}
    assert doc["metrics"]["counters"]["serving.finished"][lk] == 2


def test_healthz_reports_draining_during_drain(models):
    eng = _engine(models[1])
    states = []
    with metrics.serve() as srv:
        def cb(r, tok, last):
            d = json.loads(_get(srv.url + "/healthz"))
            states.append((d["status"], d["draining"]))

        eng.submit(np.arange(6, dtype=np.int32), 5, on_token=cb)
        eng.step()
        eng.drain()
    assert eng.stats()["faults"]["callback_errors"] == 0
    assert states[0] == ("ok", False)
    assert ("draining", True) in states


def test_unknown_path_is_404_and_reserved_names_refused():
    with metrics.serve() as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(srv.url + "/nope", timeout=10)
        assert ei.value.code == 404
    for name in ("status", "draining", "metrics"):
        with pytest.raises(ValueError):
            metrics.register_health_provider(name, dict)


def test_a_raising_health_provider_turns_healthz_to_503():
    def broken():
        raise RuntimeError("boom")

    metrics.register_health_provider("test_broken", broken)
    try:
        doc = metrics.health_snapshot(include_metrics=False)
        assert doc["status"] == "error" and "metrics" not in doc
        assert doc["test_broken"] == {"error": "RuntimeError: boom"}
        with metrics.serve() as srv:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(srv.url + "/healthz", timeout=10)
            assert ei.value.code == 503
    finally:
        del metrics._HEALTH_PROVIDERS["test_broken"]


# -- the Chrome trace ---------------------------------------------------------------
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_trace_requests", os.path.join(ROOT, "tools", "trace_requests.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chrome_trace_matches_the_jax_tool(models, tmp_path):
    """The port's request lanes, step lane and file are the JAX tool's on
    the same requests and records (but the file's tool name)."""
    tool = _jax_tool()
    eng = _engine(models[1], **{k: v for k, v in TIGHT.items()
                               if k == "num_blocks"})
    reqs = _run(eng, _prompts(), 6)
    recs = eng.flight_recorder.records()
    for tid, r in enumerate(reqs, 1):
        assert trace_requests.request_trace_events(r, tid, pid=7) == \
            tool.request_trace_events(r, tid, pid=7)
    assert trace_requests.step_lane_events(recs, 9, pid=7) == \
        tool.step_lane_events(recs, 9, pid=7)
    assert trace_requests.step_lane_events([], 9) == []
    ours = trace_requests.export_chrome_trace(
        reqs, str(tmp_path / "a.json"), step_records=recs)
    ref = tool.export_chrome_trace(reqs, str(tmp_path / "b.json"),
                                   step_records=recs)
    assert ours["traceEvents"] == ref["traceEvents"]
    loaded = json.loads((tmp_path / "a.json").read_text())
    assert loaded["traceEvents"] == json.loads(
        (tmp_path / "b.json").read_text())["traceEvents"]
    lanes = {e["tid"] for e in loaded["traceEvents"]}
    assert lanes == set(range(1, len(reqs) + 2))
    merged = trace_requests.export_chrome_trace(
        reqs[:1], str(tmp_path / "c.json"), merge=[str(tmp_path / "a.json")])
    assert len(merged["traceEvents"]) == len(loaded["traceEvents"]) + \
        len(reqs[0].trace_events) + 1
