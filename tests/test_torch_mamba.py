"""The port's Mamba-1 training slice against the JAX package on the CPU: the
plain selective scan (the CUDA kernels' plain version) and its gradients
against the JAX XLA route and the Pallas kernels in interpret mode, the
wrappers' forward residual and backward, and a tiny Mamba's logits, loss and
TrainStep trajectory with the JAX weights loaded.

Tolerances, as max |diff| / max |ref| per tensor: f32 scans and gradients
within 2e-5 (the same recurrence, summed in other orders: the XLA route
scans each chunk in a tree, the Pallas kernel and the plain version in
others); bf16 against the Pallas kernel within 1e-2 (both compute in f32
and round each output to bf16 once; a sum that lands near a rounding
boundary moves by one bf16 ulp, 2^-8). The model in f32: logits within
1e-4 relative and 1e-5 absolute, the losses of 20 TrainStep steps within
1e-4 relative and the parameters after them within 1e-5, as
``test_torch_training.py`` holds Llama. The JAX CPU route runs the scan in
the promoted dtype (bf16 for a bf16 model) where the kernels run f32, so
the models are held against each other in f32 only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import MambaConfig as JaxMambaConfig
from paddle_tpu.models import MambaForCausalLM as JaxMamba
from paddle_tpu.models.mamba import selective_scan as jax_selective_scan
from paddle_tpu.ops.pallas import selective_scan as jss
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (MambaConfig, MambaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models.mamba import _ScanFn, selective_scan
from paddle_tpu_torch.ops.cuda import selective_scan as tss
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

F32_TOL = 2e-5
BF16_OF_MAX = 1e-2
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
NAMES = ("u", "delta", "A", "B", "C", "D")


def _inputs(b, l, d, n, seed):
    """Seeded numpy u, delta = softplus(normal), A = -exp(S4D log) with a
    random spread, B, C, D (f32)."""
    rs = np.random.RandomState(seed)
    u = rs.randn(b, l, d).astype(np.float32)
    delta = np.log1p(np.exp(rs.randn(b, l, d))).astype(np.float32)
    A = -(np.arange(1, n + 1, dtype=np.float32)[None]
          * rs.uniform(0.5, 1.5, (d, 1))).astype(np.float32)
    B = rs.randn(b, l, n).astype(np.float32)
    C = rs.randn(b, l, n).astype(np.float32)
    D = rs.randn(d).astype(np.float32)
    dy = rs.randn(b, l, d).astype(np.float32)
    return [u, delta, A, B, C, D], dy


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30))


def _jax_vjp(fn, args, dy, dtype):
    xs = [jnp.asarray(a, dtype) for a in args]
    y, vjp = jax.vjp(fn, *xs)
    return np.asarray(y, np.float32), [np.asarray(g, np.float32)
                                       for g in vjp(jnp.asarray(dy, dtype))]


def _torch_vjp(args, dy, dtype, chunk):
    xs = [torch.tensor(a, dtype=dtype, requires_grad=True) for a in args]
    y = selective_scan(*xs, chunk=chunk)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy, dtype=dtype))
    assert y.dtype == dtype and all(g.dtype == dtype for g in grads)
    return (y.detach().float().numpy(),
            [g.float().numpy() for g in grads])


@pytest.mark.parametrize("l,chunk", [(64, 16), (50, 16), (40, 64)])
def test_plain_scan_matches_xla_route(l, chunk):
    """Forward and the gradient of every input against the JAX XLA route
    (``use_pallas=False``), f32; l = 50 pads the last chunk, l = 40 runs
    one short chunk."""
    args, dy = _inputs(2, l, 24, 16, seed=l)
    jy, jg = _jax_vjp(lambda *a: jax_selective_scan(
        *a, chunk=chunk, use_pallas=False), args, dy, jnp.float32)
    ty, tg = _torch_vjp(args, dy, torch.float32, chunk)
    assert _rel(ty, jy) <= F32_TOL
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= F32_TOL, name


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_OF_MAX)])
def test_plain_scan_matches_pallas_interpret(dtype, tol):
    """Forward and gradients against ``selective_scan_pallas`` in interpret
    mode at the JAX tests' shape (b1 l64 d128 n4), in f32 and in bf16: the
    kernels' semantics, f32 math, y and every gradient in its input's
    dtype."""
    args, dy = _inputs(1, 64, 128, 4, seed=3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jg = _jax_vjp(lambda *a: jss.selective_scan_pallas(
        *a, chunk=16, interpret=True), args, dy, jdt)
    ty, tg = _torch_vjp(args, dy, tdt, 16)
    assert _rel(ty, jy) <= tol
    for name, a, b in zip(NAMES, tg, jg):
        assert _rel(a, b) <= tol, name


def test_forward_residual_matches_pallas():
    """The state entering each chunk of 64 steps, ``[b, l/64, n, d]`` f32,
    as ``_scan_fwd`` keeps it (chunk 64), with l = 128 (two chunks)."""
    args, _ = _inputs(2, 128, 128, 16, seed=4)
    u, delta, A, B, C, _ = args
    _, (*_, jbounds, _) = jss._scan_fwd(
        *(jnp.asarray(a) for a in (u, delta, A, B, C)), 64, True)
    y, bounds = tss.selective_scan_fwd(
        *(torch.tensor(a) for a in (u, delta, A, B, C)))
    assert tuple(bounds.shape) == (2, 2, 16, 128)
    assert float(bounds[:, 0].abs().max()) == 0.0
    assert _rel(bounds.numpy(), np.asarray(jbounds)) <= F32_TOL
    assert y.dtype == torch.float32


def test_autograd_function_on_cpu():
    """The CUDA path's autograd function, driven with CPU tensors (its two
    wrappers then take their plain versions), against the plain version's
    own autograd: the residual and the gradients' dtypes travel through."""
    args, dy = _inputs(2, 70, 16, 8, seed=5)
    xs = [torch.tensor(a, requires_grad=True) for a in args[:5]]
    y = _ScanFn.apply(*xs)
    grads = torch.autograd.grad(y, xs, torch.tensor(dy))
    ys = [torch.tensor(a, requires_grad=True) for a in args[:5]]
    y_ref = tss.selective_scan_reference(*ys, 64)
    refs = torch.autograd.grad(y_ref, ys, torch.tensor(dy))
    assert _rel(y.detach().numpy(), y_ref.detach().numpy()) == 0.0
    for name, a, b in zip(NAMES, grads, refs):
        assert _rel(a.numpy(), b.numpy()) <= F32_TOL, name


def test_kernels_refuse_more_than_16_states():
    """The kernels hold at most 16 states per channel; a CUDA call with more
    must raise rather than fall back (checked before any launch)."""
    with pytest.raises(NotImplementedError, match="16 states"):
        tss._check_states("selective_scan", 17)
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        selective_scan(x, x, torch.empty(8, 4, device="meta"),
                       torch.empty(1, 4, 4, device="meta"),
                       torch.empty(1, 4, 4, device="meta"),
                       torch.empty(8, device="meta"))


# ------------------------------------------------------------- the slice
TINY = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
            state_size=16, scan_chunk=16, dtype="float32")


def _model_pair(seed):
    paddle.seed(seed)
    jm = JaxMamba(JaxMambaConfig(**TINY))
    tm = MambaForCausalLM(MambaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed, shape=(2, 40)):
    ids = np.random.RandomState(seed).randint(0, TINY["vocab_size"], shape)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def test_mamba_logits_and_loss_match_jax():
    """The JAX weights load (linear weights transposed, the conv weight
    ``[d, 1, k]`` as it is); logits and the shifted mean loss."""
    jm, tm = _model_pair(61)
    assert tm.config.dt_rank == 4
    ids, labels = _batch(62)
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


def test_mamba_train_step_matches_jax():
    """20 TrainStep steps with AdamW (lr 1e-3, wd 0.1, clip 1.0) against the
    JAX TrainStep: the loss at every step and every parameter after."""
    jm, tm = _model_pair(71)
    ids, labels = _batch(72)
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


def test_mamba_bf16_parameters_follow_the_model():
    """As ``astype`` leaves the JAX model, every parameter (A_log and D
    too) is bf16, and a bf16 forward and backward run on the CPU."""
    cfg = MambaConfig(**{**TINY, "dtype": "bfloat16"})
    tm = MambaForCausalLM(cfg, device="cpu")
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}
    ids, labels = _batch(81, (2, 20))
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    assert logits.dtype == torch.bfloat16 and loss.dtype == torch.float32
    loss.backward()
    assert all(torch.isfinite(p.grad.float()).all() for p in tm.parameters())
