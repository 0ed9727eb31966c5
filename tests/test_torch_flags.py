"""The port's flag registry (``paddle_tpu_torch/core/flags.py``) against
the JAX package's (``paddle_tpu/core/flags.py``): the same 60 definitions
with the same defaults and types, the same parsing of ``FLAGS_<name>`` from
the environment and of strings given to ``set_flags``, and the same
refusals (unknown names, wrong types, values a validator rejects)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import paddle_tpu.core as jcore
import paddle_tpu.core.flags as jflags
import paddle_tpu_torch.core as tcore
import paddle_tpu_torch.core.flags as tflags

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_flags():
    """Both registries' values as they were before the test."""
    saved = (dict(tflags._registry._values), dict(jflags._registry._values))
    yield
    tflags._registry._values.update(saved[0])
    jflags._registry._values.update(saved[1])


def test_the_sixty_definitions_and_defaults_match_jax():
    """Every flag of JAX's ``core/flags.py`` (``metrics`` is defined in its
    ``core/metrics.py``; the port keeps that switch in its own
    ``core/metrics.py``) with JAX's default, type and validator."""
    ours = tcore.get_flags()
    assert len(ours) == 60
    assert set(jflags.get_flags()) - set(ours) <= {"metrics"}
    # against JAX's defaults, not its values: a test of the JAX package
    # run earlier in this process may have set one and left it so
    assert ours == {n: jflags._registry._defs[n].default for n in ours}
    for name in ours:
        t, j = tflags._registry._defs[name], jflags._registry._defs[name]
        assert (t.default, t.ty) == (j.default, j.ty), name
        assert (t.validator is None) == (j.validator is None), name
    assert ours["mamba_logdepth_scan"] is False
    assert ours["selective_scan_blocks"] == ""


@pytest.mark.parametrize("name, value", [
    ("mamba_logdepth_scan", True), ("mamba_logdepth_scan", "yes"),
    ("mamba_logdepth_scan", "Off"), ("benchmark_iters", "7"),
    ("distributed_timeout_s", 5), ("selective_scan_blocks", "32"),
    ("serving_kv_cache_dtype", "int8"), ("pallas_fallback", "raise")])
def test_set_flags_parses_as_jax(restore_flags, name, value):
    tcore.set_flags({name: value})
    jcore.set_flags({name: value})
    got, want = tcore.get_flags(name), jcore.get_flags(name)
    assert got == want and type(got[name]) is type(want[name])


@pytest.mark.parametrize("name, value, error", [
    ("no_such_flag", 1, KeyError), ("benchmark_iters", 1.5, TypeError),
    ("mamba_logdepth_scan", "maybe", ValueError),
    ("serving_kv_cache_dtype", "fp8", ValueError),
    ("pallas_fallback", "never", ValueError),
    ("log_level", "x", ValueError)])
def test_refusals_match_jax(restore_flags, name, value, error):
    for mod in (tcore, jcore):
        with pytest.raises(error):
            mod.set_flags({name: value})
    with pytest.raises(KeyError):
        tflags.flag("no_such_flag")
    with pytest.raises(ValueError):
        tflags.define_flag("mamba_logdepth_scan", True)


def test_environment_sets_the_defaults():
    """``FLAGS_<name>`` read when the registry is built, parsed as JAX
    parses it (a bad boolean fails the import, as in JAX)."""
    env = dict(os.environ, FLAGS_mamba_logdepth_scan="on",
               FLAGS_benchmark_iters="7", FLAGS_selective_scan_blocks="32",
               FLAGS_fleet_slo_step_ms="250")
    code = ("import json; from paddle_tpu_torch.core import get_flags; "
            "print(json.dumps(get_flags(['mamba_logdepth_scan', "
            "'benchmark_iters', 'selective_scan_blocks', "
            "'fleet_slo_step_ms'])))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"mamba_logdepth_scan": jflags._parse("on", bool),
                   "benchmark_iters": 7, "selective_scan_blocks": "32",
                   "fleet_slo_step_ms": 250.0}
    bad = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(env, FLAGS_mamba_logdepth_scan="maybe"),
                         capture_output=True, text=True, timeout=120)
    assert bad.returncode != 0 and "cannot parse boolean" in bad.stderr


def test_flags_the_port_ignores_warn_once(restore_flags):
    """A flag outside ``ACTED_ON`` set away from its default warns once;
    its default, and the flags the port reads, do not warn."""
    import warnings

    assert tflags.ACTED_ON == {"mamba_logdepth_scan",
                               "selective_scan_blocks"}
    tflags._registry._warned.discard("benchmark_iters")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tcore.set_flags({"mamba_logdepth_scan": True,
                         "selective_scan_blocks": "32"})
        tcore.set_flags({"benchmark_iters": tflags._registry._defs[
            "benchmark_iters"].default})
        assert not caught
        tcore.set_flags({"benchmark_iters": 7})
        tcore.set_flags({"benchmark_iters": 9})
    assert len(caught) == 1
    assert "'benchmark_iters'" in str(caught[0].message)
    assert "does not act on it" in str(caught[0].message)
