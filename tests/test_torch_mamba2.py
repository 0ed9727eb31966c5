"""The port's Mamba-2 training slice against the JAX package on the CPU: the
plain chunked SSD (the CUDA kernels' plain version) and its gradients
against the JAX XLA route, the sequential oracle and the Pallas kernels in
interpret mode, the forward wrapper's chunk states, the autograd function
and a strong decay, and a tiny Mamba-2's logits, loss and TrainStep
trajectory with the JAX weights loaded.

Tolerances, as max |diff| / max |ref| per tensor: f32 against the XLA route
within 2e-5 (the same chunked products in f32, summed in other orders);
against the oracle and the Pallas kernel within 2e-4, the level at which
``tests/test_ssd_pallas.py`` holds those two to each other (the oracle
sums l steps one after the other, the kernel exponentiates cumsums formed
by a triangular product); bf16 against the Pallas kernel within 1e-2 (both
compute in f32 and round y to bf16 once; an output near a rounding boundary
moves by one bf16 ulp, 2^-8). The model in f32: logits within 1e-4
relative and 1e-5 absolute, the losses of 20 TrainStep steps within 1e-4
relative and the parameters after them within 1e-5, as
``test_torch_training.py`` holds Llama.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import Mamba2Config as JaxMamba2Config
from paddle_tpu.models import Mamba2ForCausalLM as JaxMamba2
from paddle_tpu.ops.fused import ssd as jssd
from paddle_tpu.ops.pallas import ssd as jpssd
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (Mamba2Config, Mamba2ForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops.cuda import ssd as tssd
from paddle_tpu_torch.ops.fused.ssd import _SSDFn, ssd_chunked
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

F32_TOL = 2e-5
ORACLE_TOL = 2e-4
BF16_OF_MAX = 1e-2
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
NAMES = ("x", "dt", "A", "B", "C", "D")


def _inputs(b, l, h, dh, ds, seed):
    """Seeded numpy x, dt = softplus(normal), A < 0, B, C (the scales of
    ``tests/test_ssd_pallas.py``), D and a cotangent dy (f32)."""
    rs = np.random.RandomState(seed)
    x = (0.5 * rs.randn(b, l, h, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rs.randn(b, l, h))).astype(np.float32)
    A = (-np.abs(rs.randn(h)) - 0.1).astype(np.float32)
    B = (0.5 * rs.randn(b, l, ds)).astype(np.float32)
    C = (0.5 * rs.randn(b, l, ds)).astype(np.float32)
    D = rs.randn(h).astype(np.float32)
    dy = rs.randn(b, l, h, dh).astype(np.float32)
    return [x, dt, A, B, C, D], dy


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _jax_vjp(fn, args, dy, dtype=jnp.float32):
    xs = [jnp.asarray(a, dtype) for a in args]
    y, vjp = jax.vjp(jax.jit(fn), *xs)
    return np.asarray(y, np.float32), [np.asarray(g, np.float32)
                                       for g in vjp(jnp.asarray(dy, dtype))]


def _torch_vjp(fn, args, dy, dtype=torch.float32):
    xs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
    y = fn(*xs)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy, dtype=dtype))
    assert y.dtype == dtype and all(g.dtype == dtype for g in grads)
    return (y.detach().float().numpy(),
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("l,chunk,ds", [(64, 16, 64), (50, 16, 64),
                                        (40, 64, 128), (96, 32, 128)])
def test_plain_ssd_matches_xla_route(l, chunk, ds):
    """Forward and the gradient of every input against the JAX XLA route
    (``ssd_chunked.raw_fn``), f32; l = 50 pads the last chunk, l = 40 runs
    one short chunk."""
    args, dy = _inputs(2, l, 3, 64, ds, seed=l + ds)
    jy, jg = _jax_vjp(lambda *a: jssd.ssd_chunked.raw_fn(*a, chunk=chunk),
                      args, dy)
    ty, tg = _torch_vjp(lambda *a: ssd_chunked(*a, chunk=chunk), args, dy)
    assert _rel(ty, jy) <= F32_TOL
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= F32_TOL, name


@pytest.mark.parametrize("ds", [64, 128])
def test_plain_ssd_runs_float64_in_float64(ds):
    """The plain version evaluates float64 inputs in float64 (the oracle
    ``chip_smoke.py`` holds the f32 kernels to): y, the chunk states and
    every gradient come back float64 and agree with the JAX XLA route (f32)
    within F32_TOL; f32 inputs still compute in f32."""
    args, dy = _inputs(2, 70, 3, 64, ds, seed=ds)
    jy, jg = _jax_vjp(lambda *a: jssd.ssd_chunked.raw_fn(*a, chunk=32),
                      args, dy)
    ty, tg = _torch_vjp(lambda *a: tssd.ssd_chunked_reference(*a, 32), args,
                        dy, torch.float64)
    assert _rel(ty, jy) <= F32_TOL
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= F32_TOL, name
    with torch.no_grad():
        _, s64 = tssd.ssd_chunked_reference(
            *(torch.tensor(a, dtype=torch.float64) for a in args), 32, True)
        _, s32 = tssd.ssd_chunked_reference(
            *(torch.tensor(a) for a in args), 32, True)
    assert s64.dtype == torch.float64 and s32.dtype == torch.float32
    assert _rel(s32.numpy(), s64.numpy()) <= F32_TOL


@pytest.mark.parametrize("ref", ["oracle", "pallas"])
@pytest.mark.parametrize("l,ds", [(40, 64), (32, 128)])
def test_plain_ssd_matches_oracle_and_pallas(ref, l, ds):
    """Forward and gradients against the sequential oracle
    (``ssd_reference``) and the Pallas kernels in interpret mode
    (``ssd_pallas``, chunk 32), f32; l = 40 pads the last chunk of both."""
    args, dy = _inputs(1, l, 2, 64, ds, seed=7 + l)
    fn = jssd.ssd_reference if ref == "oracle" else (
        lambda *a: jpssd.ssd_pallas(*a, chunk=32, interpret=True))
    jy, jg = _jax_vjp(fn, args, dy)
    ty, tg = _torch_vjp(lambda *a: ssd_chunked(*a, chunk=16), args, dy)
    assert _rel(ty, jy) <= ORACLE_TOL
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= ORACLE_TOL, name


def test_plain_oracle_matches_jax_oracle():
    """The port's sequential oracle against JAX's, and against its own
    chunked version (f32)."""
    args, _ = _inputs(2, 37, 2, 64, 64, seed=11)
    jy = np.asarray(jssd.ssd_reference(*(jnp.asarray(a) for a in args)))
    ty = tssd.ssd_reference(*(torch.tensor(a) for a in args)).numpy()
    tc = tssd.ssd_chunked_reference(*(torch.tensor(a) for a in args),
                                    chunk=16).numpy()
    assert _rel(ty, jy) <= F32_TOL
    assert _rel(tc, ty) <= ORACLE_TOL


def test_bf16_forward_matches_pallas():
    """bf16 x, B, C and dt through the plain version and the interpret-mode
    Pallas kernel with D = 0 (the kernel adds its D skip after a first
    rounding, the XLA route before its only one)."""
    args, _ = _inputs(1, 64, 2, 64, 64, seed=13)
    args[5] = np.zeros_like(args[5])
    jy = jpssd.ssd_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in args),
                          chunk=32, interpret=True)
    ty = ssd_chunked(*(torch.tensor(a).bfloat16() for a in args), chunk=16)
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    assert _rel(ty.float().numpy(), np.asarray(jy, np.float32)) \
        <= BF16_OF_MAX


@pytest.mark.parametrize("dh,ds", [(64, 64), (64, 128)])
def test_forward_states_match_pallas(dh, ds):
    """The state entering each chunk of ``kernel_chunk(dh, ds)`` steps,
    ``[b, nc, h, dh, ds]`` f32, as ``_run_fwd`` keeps it at that chunk, with
    l = 128 (two or four chunks)."""
    args, _ = _inputs(2, 128, 3, dh, ds, seed=17)
    x, dt, A, B, C, D = args
    chunk = tssd.kernel_chunk(dh, ds)
    assert chunk == (64 if ds == 64 else 32)
    _, jbounds = jpssd._run_fwd(
        jnp.asarray(x.transpose(0, 2, 1, 3)), jnp.asarray(dt.transpose(0, 2, 1)),
        jnp.asarray(B), jnp.asarray(C), jnp.asarray(A.reshape(-1, 1)), chunk,
        True)
    y, states = tssd.ssd_fwd(*(torch.tensor(a) for a in args))
    assert tuple(states.shape) == (2, 128 // chunk, 3, dh, ds)
    assert float(states[:, 0].abs().max()) == 0.0
    assert _rel(states.numpy(), np.asarray(jbounds)) <= F32_TOL
    assert y.dtype == torch.float32


def test_autograd_function_on_cpu():
    """The CUDA path's autograd function, driven with CPU tensors (its two
    wrappers then take their plain versions), against the plain version's
    own autograd at a ragged length."""
    args, dy = _inputs(2, 70, 3, 64, 64, seed=19)
    ty, tg = _torch_vjp(_SSDFn.apply, args, dy)
    ry, rg = _torch_vjp(lambda *a: tssd.ssd_chunked_reference(*a, 64),
                        args, dy)
    assert _rel(ty, ry) == 0.0
    for name, a, b in zip(NAMES, tg, rg):
        assert _rel(a, b) <= F32_TOL, name


def test_strong_decay_stays_finite():
    """A = -16 and dt ~ 10 on part of the sequence: cum falls by ~1e4
    within a chunk and a_t = exp(A dt) is exactly 0 in f32. y and every
    gradient stay finite (the mask is on the exponent, L never factored)
    and agree with the XLA route at chunk 16, through the autograd
    function (chunk 64) and the plain version (chunk 32)."""
    args, dy = _inputs(1, 96, 2, 64, 64, seed=23)
    args[2] = np.array([-16.0, -1.0], np.float32)
    args[1][:, 20:70] = 10.0
    assert np.exp(np.float32(-16.0 * 10.0)) == 0.0
    jy, jg = _jax_vjp(lambda *a: jssd.ssd_chunked.raw_fn(*a, chunk=16),
                      args, dy)
    for fn in (_SSDFn.apply, lambda *a: ssd_chunked(*a, chunk=32)):
        ty, tg = _torch_vjp(fn, args, dy)
        assert np.isfinite(ty).all()
        assert _rel(ty, jy) <= ORACLE_TOL
        for name, a, b in zip(NAMES, tg, jg):
            assert np.isfinite(a).all(), name
            assert _rel(a, b) <= ORACLE_TOL, name


def test_kernels_refuse_other_widths():
    """The kernels take dh and ds in {64, 128}; a CUDA call with another
    width raises rather than falling back (checked before any launch), and
    tensors off the CPU and CUDA are refused."""
    for dh, ds in ((32, 64), (64, 96), (192, 64), (64, 256)):
        with pytest.raises(NotImplementedError, match="64 or 128"):
            tssd._check_dims("ssd", dh, ds)
    for dh, ds in ((64, 64), (64, 128), (128, 64), (128, 128)):
        tssd._check_dims("ssd", dh, ds)
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        ssd_chunked(m(1, 4, 2, 64), m(1, 4, 2), m(2), m(1, 4, 64),
                    m(1, 4, 64), m(2))


def test_strided_rows_pass_in_place():
    """x, B and C as the model hands them over, strided views of one conv
    output, reach the kernels without a copy; other layouts are copied."""
    xc = torch.randn(2, 5, 3 * 64 + 2 * 64)
    x = xc[..., :192].unflatten(-1, (3, 64))
    B = xc[..., 192:256]
    for t in (x, B):
        t2, s = tssd._rows(t, torch.float32)
        assert t2.data_ptr() == t.data_ptr() and s == xc.shape[-1]
    t2, s = tssd._rows(x.transpose(0, 1), torch.float32)
    assert t2.is_contiguous() and s == 192
    t2, s = tssd._rows(B, torch.bfloat16)
    assert t2.dtype == torch.bfloat16 and s == 64


# ------------------------------------------------------------- the slice
TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            state_size=64, head_dim=64, ssd_chunk=16, dtype="float32")


def _model_pair(seed):
    paddle.seed(seed)
    jm = JaxMamba2(JaxMamba2Config(**TINY))
    tm = Mamba2ForCausalLM(Mamba2Config(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, shape=(2, 40)):
    ids = np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def test_model_views_pass_in_place(monkeypatch):
    """The views Mamba2Block hands to ssd_chunked (x, B and C of its conv
    output) reach the kernels without a copy: ``_rows`` keeps their
    storage and gives the conv width as the stride between tokens."""
    from paddle_tpu_torch.models import mamba2 as tmamba2

    seen = []

    def spy(x, dt, A, B, C, D, chunk):
        seen.append((x, dt, B, C))
        return ssd_chunked(x, dt, A, B, C, D, chunk)

    monkeypatch.setattr(tmamba2, "ssd_chunked", spy)
    cfg = Mamba2Config(**{**TINY, "num_hidden_layers": 1})
    model = Mamba2ForCausalLM(cfg, device="cpu")
    model(torch.randint(0, cfg.vocab_size, (2, 24)))
    (x, dt, B, C), = seen
    conv = cfg.inner_size + 2 * cfg.state_size
    for t, stride in ((x, conv), (B, conv), (C, conv),
                      (dt, cfg.num_heads)):
        t2, s = tssd._rows(t, torch.float32)
        assert t2.data_ptr() == t.data_ptr() and s == stride


def test_mamba2_logits_and_loss_match_jax():
    """The JAX weights load (linear weights transposed, the conv weight
    ``[conv_dim, 1, k]`` as it is); logits and the shifted mean loss."""
    jm, tm = _model_pair(91)
    assert tm.config.num_heads == 2
    ids, labels = _batch(92)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(jm(paddle.to_tensor(ids)).numpy()),
            rtol=1e-4, atol=1e-5)
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        tloss, tlogits = tm(torch.from_numpy(ids),
                            labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)
    assert torch.equal(tlogits, logits)


def test_mamba2_train_step_matches_jax():
    """20 TrainStep steps with AdamW (lr 1e-3, wd 0.1, epsilon 1e-6, clip
    1.0) against the JAX TrainStep: the loss at every step and every
    parameter after.

    The epsilon is AdamW's 1e-6, not its default 1e-8, in both: about 3000
    in_proj weights here get gradients below 1e-7, whose f32 rounding noise
    (~1e-9, the summation order) moves ``g / (|g| + 1e-8)`` by up to a
    percent, so one weight drifts by lr x 1% = 1e-5 in the first step
    although every gradient agrees within 5e-6 of its tensor's max."""
    jm, tm = _model_pair(101)
    ids, labels = _batch(102)
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=1e-3, weight_decay=0.1, epsilon=1e-6,
        parameters=jm.parameters()), clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=1e-3, weight_decay=0.1, epsilon=1e-6,
        parameters=tm.parameters()), clip_norm=1.0)
    jl, tl = [], []
    for _ in range(20):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] - 0.1
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        ours = p.detach().numpy()
        if name.rsplit(".", 1)[0] in linear and name.endswith(".weight"):
            ours = ours.T
        np.testing.assert_allclose(ours, jparams[name], atol=PARAM_ATOL,
                                   err_msg=name)


def test_mamba2_bf16_parameters_follow_the_model():
    """As ``astype`` leaves the JAX model, every parameter (A_log, D and
    dt_bias too) is bf16, and a bf16 forward and backward run on the
    CPU."""
    cfg = Mamba2Config(**{**TINY, "dtype": "bfloat16"})
    tm = Mamba2ForCausalLM(cfg, device="cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    ids, labels = _batch(111, (2, 20))
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert all(torch.isfinite(p.grad.float()).all() for p in tm.parameters())
