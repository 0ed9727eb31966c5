"""The port's RWKV-5 training slice against the JAX package on the CPU: the
plain WKV (the CUDA kernels' plain version) and its gradients against the
JAX XLA chunked route, the step-by-step oracle and the Pallas kernels in
interpret mode; ``layer_norm`` and ``group_norm``; and a tiny RWKV's
logits, loss and TrainStep trajectory with the JAX weights loaded.

Tolerances, as max |diff| / max |ref| per tensor: f32 WKV and gradients
within 2e-5 (the same chunked formula in both frameworks, summed in other
orders); bf16 against the Pallas kernel within 1e-2 (both compute in f32
and round r/k/v gradients and y to bf16 once: one bf16 ulp is 2^-8);
``layer_norm`` and ``group_norm`` in bf16 bit for bit (f32 statistics, one
rounding before the affine terms, as the JAX functions do). The model in
f32: logits within 1e-4 relative and 1e-5 absolute, the losses of 20
TrainStep steps within 1e-4 relative and the parameters after them within
1e-5, as ``test_torch_training.py`` holds Llama.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import RwkvConfig as JaxRwkvConfig
from paddle_tpu.models import RwkvForCausalLM as JaxRwkv
from paddle_tpu.ops.fused import rwkv as jrwkv
from paddle_tpu.ops.pallas.wkv import wkv_pallas
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (RwkvConfig, RwkvForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn.functional import group_norm, layer_norm
from paddle_tpu_torch.ops.cuda import wkv as twkv
from paddle_tpu_torch.ops.fused import rwkv as trwkv
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_OF_MAX = 1e-2
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
NAMES = ("r", "k", "v", "logw", "u")


def _inputs(b, l, h, d, seed, strong_decay=False):
    """Seeded numpy r, k, v (scale 0.5), logw from mild to strong decays,
    u; with ``strong_decay`` a few channels at the -1e10 floor of
    ``rwkv_log_decay`` (w exactly 0) and decays down to exp(-20)."""
    rs = np.random.RandomState(seed)
    r, k, v = (rs.randn(b, l, h, d).astype(np.float32) * 0.5
               for _ in range(3))
    hi = 20.0 if strong_decay else 5.0
    logw = -rs.uniform(0.02, hi, (h, d)).astype(np.float32)
    if strong_decay:
        logw[0, :3] = -1e10
        logw[-1, -2:] = -1e10
    u = rs.randn(h, d).astype(np.float32) * 0.3
    dy = rs.randn(b, l, h, d).astype(np.float32)
    return [r, k, v, logw, u], dy


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _jax_vjp(fn, args, dy, dtype):
    xs = [jnp.asarray(a, dtype if i < 3 else jnp.float32)
          for i, a in enumerate(args)]
    y, vjp = jax.vjp(fn, *xs)
    return np.asarray(y, np.float32), [np.asarray(g, np.float32)
                                       for g in vjp(jnp.asarray(dy, dtype))]


def _torch_vjp(args, dy, dtype, chunk, subchunk):
    xs = [torch.tensor(a, dtype=dtype if i < 3 else torch.float32,
                       requires_grad=True) for i, a in enumerate(args)]
    y = trwkv.rwkv_linear_attention(*xs, chunk=chunk, subchunk=subchunk)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy, dtype=dtype))
    assert y.dtype == dtype
    assert [g.dtype for g in grads] == [x.dtype for x in xs]
    return (y.detach().float().numpy(),
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("l,chunk,subchunk,strong", [
    (64, 32, 16, False), (40, 16, 8, False), (37, 32, 32, True)])
def test_plain_wkv_matches_xla_route(l, chunk, subchunk, strong):
    """Forward and the gradient of every input against the JAX XLA chunked
    route, f32: l = 40 and 37 pad the last chunk, sub == chunk runs the
    pure cube, and the strong-decay case has w = 0 channels (no NaN)."""
    args, dy = _inputs(2, l, 2, 64, seed=l, strong_decay=strong)
    jy, jg = _jax_vjp(lambda *a: jrwkv.rwkv_linear_attention.raw_fn(
        *a, chunk=chunk, subchunk=subchunk), args, dy, jnp.float32)
    ty, tg = _torch_vjp(args, dy, torch.float32, chunk, subchunk)
    assert np.isfinite(ty).all() and all(np.isfinite(g).all() for g in tg)
    assert _rel(ty, jy) <= F32_TOL
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= F32_TOL, name


def test_plain_wkv_matches_oracle():
    """The plain chunked version against the step-by-step oracle (and the
    JAX oracle), which takes the decay w itself."""
    args, _ = _inputs(2, 50, 3, 64, seed=8)
    r, k, v, logw, u = args
    ours = twkv.wkv_reference(*(torch.tensor(a) for a in args), 16, 8)
    oracle = trwkv.rwkv_linear_attention_reference(
        torch.tensor(r), torch.tensor(k), torch.tensor(v),
        torch.exp(torch.tensor(logw)), torch.tensor(u))
    joracle = jrwkv.rwkv_linear_attention_reference(
        jnp.asarray(r), jnp.asarray(k), jnp.asarray(v),
        jnp.exp(jnp.asarray(logw)), jnp.asarray(u))
    assert _rel(oracle.numpy(), np.asarray(joracle)) <= F32_TOL
    assert _rel(ours.numpy(), oracle.numpy()) <= F32_TOL


@pytest.mark.parametrize("dtype,tol,strong", [
    ("float32", F32_TOL, False), ("bfloat16", BF16_OF_MAX, False),
    ("float32", F32_TOL, True)])
def test_plain_wkv_matches_pallas_interpret(dtype, tol, strong):
    """Forward and gradients against ``wkv_pallas`` in interpret mode at
    the JAX tests' shape (l64 h2 d64): f32, bf16 r/k/v (y and dr, dk, dv
    in bf16), and a strong-decay case with w = 0 channels."""
    args, dy = _inputs(1, 64, 2, 64, seed=9, strong_decay=strong)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jg = _jax_vjp(lambda *a: wkv_pallas(
        *a, chunk=32, subchunk=16, interpret=True), args, dy, jdt)
    ty, tg = _torch_vjp(args, dy, tdt, 32, 16)
    assert _rel(ty, jy) <= tol
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= tol, name


def test_decay_clamp_zeroes_dlogw():
    """logw >= 0 is clamped to 0 (w = 1) and gets no gradient, as the
    Pallas backward's ``where(lw < 0, dlw, 0)``."""
    args, dy = _inputs(1, 24, 1, 64, seed=10)
    args[3][0, :4] = [0.0, 0.5, 2.0, -0.1]
    _, tg = _torch_vjp(args, dy, torch.float32, 8, 4)
    jy, jg = _jax_vjp(lambda *a: wkv_pallas(
        *a, chunk=8, subchunk=4, interpret=True), args, dy, jnp.float32)
    assert (tg[3][0, :3] == 0).all() and tg[3][0, 3] != 0
    assert _rel(tg[3], jg[3]) <= F32_TOL


def test_autograd_function_on_cpu():
    """The CUDA path's autograd function, driven with CPU tensors (its two
    wrappers then take their plain versions), against the plain version's
    own autograd."""
    args, dy = _inputs(2, 40, 2, 64, seed=11)
    xs = [torch.tensor(a, requires_grad=True) for a in args]
    y = trwkv._WKV.apply(*xs)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy))
    ys = [torch.tensor(a, requires_grad=True) for a in args]
    refs = torch.autograd.grad(twkv.wkv_reference(*ys), ys,
                               torch.tensor(dy))
    for name, a, b in zip(NAMES, grads, refs):
        assert _rel(a.numpy(), b.numpy()) == 0.0, name


def test_kernels_refuse_other_head_dims():
    with pytest.raises(NotImplementedError, match="head_dim 64 or 128"):
        twkv._check_head_dim("wkv", 32)
    x = torch.empty(1, 4, 1, 64, device="meta")
    w = torch.empty(1, 64, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        trwkv.rwkv_linear_attention(x, x, x, w, w)


def test_token_shift_and_log_decay_match_jax():
    rs = np.random.RandomState(12)
    x = rs.randn(2, 5, 8).astype(np.float32)
    np.testing.assert_array_equal(
        trwkv.token_shift(torch.tensor(x)).numpy(),
        np.asarray(jrwkv.token_shift(jnp.asarray(x))))
    a = np.asarray([[-3.0, 0.0, 2.5, 30.0, 100.0]], np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        ours = trwkv.rwkv_log_decay(torch.tensor(a, dtype=dt))
        ref = jrwkv.rwkv_log_decay(jnp.asarray(a, jdt))
        assert ours.dtype == dt
        np.testing.assert_array_equal(ours.float().numpy(),
                                      np.asarray(ref, np.float32))


@pytest.mark.parametrize("shape", [(6, 128), (2, 3, 96)])
def test_layer_norm_bit_for_bit_in_bf16(shape):
    rs = np.random.RandomState(13)
    x = (rs.randn(*shape) * 3 + 1).astype(np.float32)
    w = rs.randn(shape[-1]).astype(np.float32)
    b = rs.randn(shape[-1]).astype(np.float32)
    ours = layer_norm(*(torch.tensor(t, dtype=torch.bfloat16)
                        for t in (x, w, b)), eps=1e-5)
    ref = JF.layer_norm(jnp.asarray(x, jnp.bfloat16), None,
                        jnp.asarray(w, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), 1e-5)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("groups,shape", [(2, (64, 128)), (4, (3, 16, 5))])
def test_group_norm_bit_for_bit_in_bf16(groups, shape):
    rs = np.random.RandomState(14)
    x = (rs.randn(*shape) * 2 - 0.5).astype(np.float32)
    w = rs.randn(shape[1]).astype(np.float32)
    b = rs.randn(shape[1]).astype(np.float32)
    ours = group_norm(torch.tensor(x, dtype=torch.bfloat16), groups,
                      torch.tensor(w, dtype=torch.bfloat16),
                      torch.tensor(b, dtype=torch.bfloat16), eps=64e-5)
    ref = JF.group_norm(jnp.asarray(x, jnp.bfloat16), groups,
                        jnp.asarray(w, jnp.bfloat16),
                        jnp.asarray(b, jnp.bfloat16), 64e-5)
    np.testing.assert_array_equal(ours.float().numpy(),
                                  np.asarray(ref, np.float32))


# ------------------------------------------------------------- the slice
TINY = dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
            head_dim=64, wkv_chunk=16, wkv_subchunk=8, dtype="float32")


def _model_pair(seed):
    paddle.seed(seed)
    jm = JaxRwkv(JaxRwkvConfig(**TINY))
    tm = RwkvForCausalLM(RwkvConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, shape=(2, 40)):
    ids = np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def test_rwkv_logits_and_loss_match_jax():
    """The JAX weights load (``head.weight`` and every projection
    transposed by module type); logits and the shifted mean loss."""
    jm, tm = _model_pair(91)
    ids, labels = _batch(92)
    with torch.no_grad():
        logits = tm(torch.from_numpy(ids))
        np.testing.assert_allclose(
            logits.numpy(), np.asarray(jm(paddle.to_tensor(ids)).numpy()),
            rtol=1e-4, atol=1e-5)
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def test_rwkv_train_step_matches_jax():
    """20 TrainStep steps with AdamW (lr 1e-3, wd 0.1, clip 1.0) against the
    JAX TrainStep: the loss at every step and every parameter after."""
    jm, tm = _model_pair(93)
    ids, labels = _batch(94)
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=tm.parameters()),
        clip_norm=1.0)
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


def test_rwkv_bf16_parameters_follow_the_model():
    """As ``astype`` leaves the JAX model, every parameter (decay and bonus
    too) is bf16, and a bf16 forward and backward run on the CPU."""
    tm = RwkvForCausalLM(RwkvConfig(**{**TINY, "dtype": "bfloat16"}),
                         device="cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    ids, labels = _batch(95, (2, 20))
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert all(torch.isfinite(p.grad.float()).all() for p in tm.parameters())
