"""The log-depth selective scan (``FLAGS_mamba_logdepth_scan``) on the CPU:
the port's plain log-depth forward and backward (the CUDA kernels' plain
versions, ``ops/cuda/selective_scan.py``) through ``models.mamba.
selective_scan`` against JAX's ``selective_scan_pallas(..., interpret=
True)`` with the flag on, and against the port's sequential plain version;
the span rule against JAX's ``_scan_chunk``; a tiny Mamba trained on the
log-depth route against the JAX model.

Tolerances: y and the six gradients within 2e-4 of max |ref| (JAX's own
log-depth gate, ``tests/test_selective_scan_pallas.py:145-173``); the
model's logits within 1e-4 relative and 1e-5 absolute and its losses within
1e-4 relative, as ``test_torch_mamba.py`` holds it, and its parameters after
5 steps within 1e-4 (``test_torch_mamba.py`` has 1e-5 for the sequential
plain version, the XLA route's own order: the log-depth scan folds the
entering state in at step 0, the XLA route at the end, and AdamW's
normalised step turns that rounding, on the tied embedding's rows of
absent tokens, whose gradients are about 1e-7, into differences up to
4.1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.core.flags as jflags
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import MambaConfig as JaxMambaConfig
from paddle_tpu.models import MambaForCausalLM as JaxMamba
from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu_torch.core import flags as tflags
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (MambaConfig, MambaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.mamba import selective_scan
from paddle_tpu_torch.ops.cuda import selective_scan as tss
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TOL = 2e-4
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
NAMES = ("y", "u", "delta", "A", "B", "C", "D")
#: (l, chunk): JAX's case (four spans of 16), a length off the span, and
#: l < 8 (one span of 8, padded)
CASES = ((64, 16), (70, 16), (5, 64))


@pytest.fixture
def logdepth():
    """The flag on in both packages for the test, then restored."""
    saved = (tflags.flag("mamba_logdepth_scan"),
             jflags.flag("mamba_logdepth_scan"))
    tflags.set_flags({"mamba_logdepth_scan": True})
    jflags.set_flags({"mamba_logdepth_scan": True})
    yield
    tflags.set_flags({"mamba_logdepth_scan": saved[0]})
    jflags.set_flags({"mamba_logdepth_scan": saved[1]})


def _inputs(l, seed=0, b=1, d=128, n=4):
    rs = np.random.RandomState(seed)
    u = rs.randn(b, l, d).astype(np.float32)
    delta = np.log1p(np.exp(rs.randn(b, l, d))).astype(np.float32)
    A = -np.exp(rs.randn(d, n)).astype(np.float32)
    B, C = (rs.randn(b, l, n).astype(np.float32) for _ in range(2))
    D = rs.randn(d).astype(np.float32)
    dy = rs.randn(b, l, d).astype(np.float32)
    return [u, delta, A, B, C, D], dy


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _port(args, dy, chunk):
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    y = selective_scan(*xs, chunk=chunk)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy))
    return [y.detach().numpy()] + [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def jax_refs():
    """JAX's interpret-mode log-depth kernels' y and six gradients, once
    per case (the flag set around the trace)."""
    saved = jflags.flag("mamba_logdepth_scan")
    jflags.set_flags({"mamba_logdepth_scan": True})
    try:
        out = {}
        for l, chunk in CASES:
            args, dy = _inputs(l)
            y, vjp = jax.vjp(lambda *a: jss.selective_scan_pallas(
                *a, chunk=min(chunk, l), interpret=True),
                *map(jnp.asarray, args))
            out[l, chunk] = [np.asarray(y)] + [
                np.asarray(g) for g in vjp(jnp.asarray(dy))]
        return out
    finally:
        jflags.set_flags({"mamba_logdepth_scan": saved})


@pytest.mark.parametrize("l, chunk", CASES)
def test_plain_logdepth_matches_pallas_interpret(logdepth, jax_refs, l,
                                                 chunk):
    args, dy = _inputs(l)
    got = _port(args, dy, chunk)
    for name, a, r in zip(NAMES, got, jax_refs[l, chunk]):
        assert a.shape == r.shape, name
        assert _rel(a, r) <= TOL, (name, _rel(a, r))


@pytest.mark.parametrize("l, chunk", CASES)
def test_plain_logdepth_matches_the_sequential_plain_version(logdepth, l,
                                                             chunk):
    args, dy = _inputs(l, seed=1)
    got = _port(args, dy, chunk)
    tflags.set_flags({"mamba_logdepth_scan": False})
    want = _port(args, dy, chunk)
    for name, a, r in zip(NAMES, got, want):
        assert _rel(a, r) <= TOL, (name, _rel(a, r))


def test_span_states_match_the_pallas_forward():
    """The plain forward's states entering each span against the Pallas
    ``_run_fwd``'s bounds (log-depth, interpret mode), and y."""
    args, _ = _inputs(64, seed=2)
    saved = jflags.flag("mamba_logdepth_scan")
    jflags.set_flags({"mamba_logdepth_scan": True})
    try:
        u, delta, A, B, C, _ = map(jnp.asarray, args)
        y, bounds = jss._run_fwd(u, delta, A, B, C, 16, True)
    finally:
        jflags.set_flags({"mamba_logdepth_scan": saved})
    ty, tb = tss.selective_scan_logdepth_reference(
        *[torch.tensor(a) for a in args[:5]], 16)
    assert tb.shape == (1, 4, 4, 128)
    assert _rel(tb.numpy(), bounds) <= TOL and _rel(ty.numpy(), y) <= TOL


@pytest.mark.parametrize("l, chunk, blocks", [
    (1, 64, ""), (5, 64, ""), (64, 16, ""), (150, 64, ""), (20, 64, ""),
    (1024, 64, "32"), (10, 64, "16"), (100, 64, "0"), (100, 16, "8,4")])
def test_scan_span_matches_jax_scan_chunk(l, chunk, blocks):
    saved = (tflags.flag("selective_scan_blocks"),
             jflags.flag("selective_scan_blocks"))
    tflags.set_flags({"selective_scan_blocks": blocks})
    jflags.set_flags({"selective_scan_blocks": blocks})
    try:
        # JAX's model clamps the chunk to l before the kernel does
        want = jss._scan_chunk(l, 128, 16, min(chunk, l))
        assert tss.scan_span(l, chunk) == want
    finally:
        tflags.set_flags({"selective_scan_blocks": saved[0]})
        jflags.set_flags({"selective_scan_blocks": saved[1]})


def test_wrappers_on_cpu_tensors_and_the_span_rule():
    """On CPU tensors the wrappers take the plain versions (no launch
    counted) at any span, the backward checks the forward's states; the
    kernels' spans are 8, 16, 32 and 64, any other raises naming it."""
    args, dy = _inputs(40, seed=3, d=32, n=16)
    ins = [torch.tensor(a) for a in args[:5]]
    before = (tss.logdepth_launches, tss.logdepth_bwd_launches)
    y, bounds = tss.selective_scan_logdepth_fwd(*ins, 20)
    assert y.shape == (1, 40, 32) and bounds.shape == (1, 2, 16, 32)
    grads = tss.selective_scan_logdepth_bwd(*ins, bounds, torch.tensor(dy),
                                            20)
    assert [tuple(g.shape) for g in grads] == [tuple(t.shape) for t in ins]
    assert (tss.logdepth_launches, tss.logdepth_bwd_launches) == before
    with pytest.raises(ValueError, match="bounds"):
        tss.selective_scan_logdepth_bwd(*ins, bounds[:, :1].contiguous(),
                                        torch.tensor(dy), 20)
    for span in tss.LOGDEPTH_SPANS:
        tss._check_span("scan", span)
    for span in (20, 128, 4):
        with pytest.raises(NotImplementedError, match=f"span of {span}"):
            tss._check_span("scan", span)


TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            state_size=16, scan_chunk=16, dtype="float32")


def test_tiny_mamba_on_the_logdepth_route_matches_jax(logdepth):
    """A tiny Mamba (JAX's weights) with the flag on: logits, and 5
    TrainStep steps (AdamW, clip 1.0) against the JAX model and
    TrainStep (its CPU route, the chunked XLA scan: the same function)."""
    paddle.seed(81)
    jm = JaxMamba(JaxMambaConfig(**TINY))
    tm = MambaForCausalLM(MambaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    ids = np.random.RandomState(82).randint(0, 256, (2, 40))
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(ids)).numpy(),
            np.asarray(jm(paddle.to_tensor(ids)).numpy()), rtol=1e-4,
            atol=1e-5)
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=1e-3, parameters=jm.parameters()), clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(learning_rate=1e-3,
                                      parameters=tm.parameters()),
                      clip_norm=1.0)
    jl = [float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids)))
          for _ in range(5)]
    tl = [float(tstep(torch.from_numpy(ids), torch.from_numpy(ids)))
          for _ in range(5)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in tm.named_parameters():
        ours = p.detach().numpy()
        if name.rsplit(".", 1)[0] in linear and name.endswith(".weight"):
            ours = ours.T
        np.testing.assert_allclose(ours, jparams[name], atol=PARAM_ATOL,
                                   err_msg=name)
