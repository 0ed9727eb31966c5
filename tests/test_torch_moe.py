"""The port's MoE training slice against the JAX package on the CPU: the
grouped-GEMM functions against the Pallas kernels in interpret mode, the
routing, the MoE layer in both dispatches, and a tiny MoE-Llama's logits,
loss and TrainStep trajectory.

Tolerances: the grouped products and their gradients within 2e-5 (f32,
one product per element in both); the layer's output within 2e-5 and its
gradients within rtol 2e-4, atol 3e-5, as ``tests/test_moe.py`` holds the
JAX grouped path against its capacity path (the gradients sum the k
choices and the rows in other orders); bf16 within 2e-2 of max |ref| (the
two frameworks round bf16 at other places); the TrainStep losses within
1e-4 relative and the parameters within 1e-5, as
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
from paddle_tpu.models import MoELlamaConfig as JaxMoEConfig
from paddle_tpu.models import MoELlamaForCausalLM as JaxMoELlama
from paddle_tpu.ops.pallas import grouped_gemm as jgg
from paddle_tpu.parallel import GShardGate as JaxGShardGate
from paddle_tpu.parallel import MLPExperts as JaxMLPExperts
from paddle_tpu.parallel import MoELayer as JaxMoELayer
from paddle_tpu.parallel import SwitchGate as JaxSwitchGate
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (MoELlamaConfig, MoELlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops.cuda.grouped_gemm import gmm_swiglu_reference
from paddle_tpu_torch.ops.fused.grouped_gemm import (grouped_matmul,
                                                     grouped_matmul_swiglu,
                                                     grouped_matmul_tgmm)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel import (GShardGate, MLPExperts, MoELayer,
                                       SwitchGate)

torch.set_num_threads(2)

KERNEL_TOL = 2e-5
LAYER_FWD_TOL = 2e-5
LAYER_GRAD_RTOL, LAYER_GRAD_ATOL = 2e-4, 3e-5
BF16_OF_MAX = 2e-2
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5

# M = 40 rows over 4 groups: 13 rows, an empty group, one row, 17 rows, and
# 9 trash rows; the JAX kernels run with 16-row tiles, so groups straddle
GROUP_SIZES = np.asarray([13, 0, 1, 17], np.int32)
M, K, N = 40, 24, 32
TM = 16


def _np(t):
    return np.asarray(t, np.float32)


def _interp_gmm(transpose_rhs):
    return lambda lhs, rhs, gs, bias: jgg.grouped_matmul(
        lhs, rhs, gs, bias, transpose_rhs, TM, 512, 512, True)


def _trash():
    return slice(int(GROUP_SIZES.sum()), M)


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("with_bias", [True, False])
def test_grouped_matmul_and_grads_match_pallas(transpose_rhs, with_bias):
    """Forward and the three gradients of ``grouped_matmul`` by autograd
    against ``jax.vjp`` of the Pallas kernel in interpret mode; trash rows
    of the output and of dlhs are exact zeros."""
    rng = np.random.RandomState(1 + 2 * transpose_rhs + with_bias)
    G = len(GROUP_SIZES)
    rhs = rng.randn(G, K, N).astype(np.float32)
    width_in, width_out = (N, K) if transpose_rhs else (K, N)
    lhs = rng.randn(M, width_in).astype(np.float32)
    bias = rng.randn(G, width_out).astype(np.float32) if with_bias else None
    dout = rng.randn(M, width_out).astype(np.float32)
    gs = jnp.asarray(GROUP_SIZES)
    fn = _interp_gmm(transpose_rhs)
    if with_bias:
        ref, vjp = jax.vjp(lambda a, b, c: fn(a, b, gs, c), lhs, rhs, bias)
    else:
        ref, vjp = jax.vjp(lambda a, b: fn(a, b, gs, None), lhs, rhs)
    ref_grads = vjp(jnp.asarray(dout))

    args = [torch.tensor(a, requires_grad=True)
            for a in (lhs, rhs) + ((bias,) if with_bias else ())]
    out = grouped_matmul(args[0], args[1], torch.from_numpy(GROUP_SIZES),
                         args[2] if with_bias else None,
                         transpose_rhs=transpose_rhs)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(out.detach().numpy(), _np(ref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    for name, t, r in zip(("dlhs", "drhs", "dbias"), args, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL, err_msg=name)
    assert (out.detach()[_trash()] == 0).all()
    assert (args[0].grad[_trash()] == 0).all()


def test_tgmm_matches_pallas():
    """``lhs_gᵀ @ dout_g`` per group against the Pallas tgmm in interpret
    mode; the empty group's block is exactly zero."""
    rng = np.random.RandomState(5)
    lhs = rng.randn(M, K).astype(np.float32)
    dout = rng.randn(M, N).astype(np.float32)
    ref = jgg.grouped_matmul_tgmm(jnp.asarray(lhs), jnp.asarray(dout),
                                  jnp.asarray(GROUP_SIZES), TM, 512, 512,
                                  True)
    out = grouped_matmul_tgmm(torch.from_numpy(lhs), torch.from_numpy(dout),
                              torch.from_numpy(GROUP_SIZES))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    assert (out[1] == 0).all()


@pytest.mark.parametrize("recompute_activation", [False, True])
def test_grouped_swiglu_and_grads_match_pallas(recompute_activation):
    """The fused gate + up + swiglu product and its gradients against
    ``grouped_matmul_swiglu`` in interpret mode, with and without the
    recomputed residuals."""
    rng = np.random.RandomState(7 + recompute_activation)
    G = len(GROUP_SIZES)
    x = rng.randn(M, K).astype(np.float32)
    w1 = (rng.randn(G, K, 2 * N) * 0.3).astype(np.float32)
    b1 = (rng.randn(G, 2 * N) * 0.1).astype(np.float32)
    dy = rng.randn(M, N).astype(np.float32)
    gs = jnp.asarray(GROUP_SIZES)
    ref, vjp = jax.vjp(lambda a, b, c: jgg.grouped_matmul_swiglu(
        a, b, gs, c, TM, 512, 512, True, recompute_activation), x, w1, b1)
    ref_grads = vjp(jnp.asarray(dy))
    args = [torch.tensor(a, requires_grad=True) for a in (x, w1, b1)]
    out = grouped_matmul_swiglu(args[0], args[1],
                                torch.from_numpy(GROUP_SIZES), args[2],
                                recompute_activation=recompute_activation)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), _np(ref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    for name, t, r in zip(("dx", "dw1", "db1"), args, ref_grads):
        np.testing.assert_allclose(t.grad.numpy(), _np(r), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL, err_msg=name)
    assert (out.detach()[_trash()] == 0).all()
    assert (args[1].grad[1] == 0).all()          # the empty group's dw1


def test_swiglu_residuals_match_pallas():
    """The pre-activation residuals g and u the fused kernel emits."""
    rng = np.random.RandomState(9)
    G = len(GROUP_SIZES)
    x = rng.randn(M, K).astype(np.float32)
    w1 = rng.randn(G, K, 2 * N).astype(np.float32)
    b1 = rng.randn(G, 2 * N).astype(np.float32)
    refs = jgg._gmm_swiglu_call(jnp.asarray(x), jnp.asarray(w1),
                                jnp.asarray(GROUP_SIZES), jnp.asarray(b1),
                                TM, 512, 512, True, emit_residuals=True)
    outs = gmm_swiglu_reference(torch.from_numpy(x), torch.from_numpy(w1),
                                torch.from_numpy(GROUP_SIZES),
                                torch.from_numpy(b1))
    for name, o, r in zip(("y", "g", "u"), outs, refs):
        np.testing.assert_allclose(o.numpy(), _np(r), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL, err_msg=name)
        assert (o[_trash()] == 0).all()


# ragged groups for the fused swiglu: a one-row group, an empty group,
# starts off the 16-row tiles, a group over two tiles and 11 trash rows
SW_SIZES = np.asarray([1, 0, 21, 9, 28], np.int32)
SW_M = 70


@pytest.mark.parametrize("emit_residuals", [True, False])
@pytest.mark.parametrize("k,n", [(24, 40), (64, 120)])
def test_swiglu_reference_matches_pallas_at_ragged_edges(k, n,
                                                         emit_residuals):
    """The plain fused swiglu (the wgmma kernel's oracle) against
    ``_gmm_swiglu_call`` in interpret mode at widths that are multiples of
    8 but not of 128 (N = 40 and 120), with and without the residuals: y,
    g and u within 2e-5, trash rows exact zeros, no residuals when none
    are asked for."""
    rng = np.random.RandomState(11 + n + emit_residuals)
    G = len(SW_SIZES)
    x = rng.randn(SW_M, k).astype(np.float32)
    w1 = (rng.randn(G, k, 2 * n) * k ** -0.5).astype(np.float32)
    b1 = (rng.randn(G, 2 * n) * 0.1).astype(np.float32)
    refs = jgg._gmm_swiglu_call(jnp.asarray(x), jnp.asarray(w1),
                                jnp.asarray(SW_SIZES), jnp.asarray(b1), TM,
                                512, 512, True,
                                emit_residuals=emit_residuals)
    outs = gmm_swiglu_reference(torch.from_numpy(x), torch.from_numpy(w1),
                                torch.from_numpy(SW_SIZES),
                                torch.from_numpy(b1), emit_residuals)
    for name, o, r in zip(("y", "g", "u"), outs, refs):
        if r is None:
            assert o is None, name
            continue
        np.testing.assert_allclose(o.numpy(), _np(r), rtol=KERNEL_TOL,
                                   atol=KERNEL_TOL, err_msg=name)
        assert (o[int(SW_SIZES.sum()):] == 0).all(), name


# ---------------------------------------------------------------- routing
def _gate_pair(topk, cf, d, E, seed):
    paddle.seed(seed)
    jcls, tcls = ((JaxSwitchGate, SwitchGate) if topk == 1
                  else (JaxGShardGate, GShardGate))
    jg = jcls(d, E, capacity_factor=cf)
    tg = tcls(d, E, capacity_factor=cf, device="cpu")
    with torch.no_grad():
        tg.weight.copy_(torch.tensor(_np(jg.weight.numpy())))
    return jg, tg


@pytest.mark.parametrize("topk", [1, 2])
@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_route_sparse_matches_jax(topk, cf):
    """Expert choice and capacity slot exactly, gate weights and the aux
    loss within 1e-6; cf = 0.5 drops pairs."""
    d, E, n = 32, 4, 64
    jg, tg = _gate_pair(topk, cf, d, E, seed=11 + topk)
    x = np.random.RandomState(13).randn(n, d).astype(np.float32)
    jidx, jslot, jp, jaux = jg._route_sparse(jnp.asarray(x),
                                             jg.weight._data)
    tidx, tslot, tp, taux = tg._route_sparse(torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(tp.detach().numpy(), _np(jp), atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    C = tg.capacity(n)
    dropped = int((tslot.numpy() == C).sum())
    assert (dropped > 0) == (cf < 1.0)


# ------------------------------------------------------------ the layer
def _layer_pair(activation, jax_dispatch, port_dispatch, seed,
                dtype="float32"):
    paddle.seed(seed)
    E, d, h = 4, 32, 64
    ja = JaxMoELayer(JaxGShardGate(d, E, capacity_factor=2.0),
                     JaxMLPExperts(E, d, h, activation=activation),
                     dispatch=jax_dispatch)
    if dtype != "float32":
        ja.astype(dtype)
    tdt = getattr(torch, dtype)
    tl = MoELayer(GShardGate(d, E, capacity_factor=2.0, device="cpu",
                             dtype=tdt),
                  MLPExperts(E, d, h, activation=activation, device="cpu",
                             dtype=tdt), dispatch=port_dispatch)
    with torch.no_grad():
        tl.gate.weight.copy_(torch.tensor(_np(ja.gate.weight.numpy())))
        for name, p in tl.experts.named_parameters():
            p.copy_(torch.tensor(
                _np(dict(ja.experts.named_parameters())[name].numpy())))
    return ja, tl


@pytest.mark.parametrize("activation,jax_dispatch,port_dispatch", [
    ("swiglu", "grouped_interpret", "grouped"),
    ("swiglu", "capacity", "capacity"),
    ("gelu", "capacity", "capacity"),
])
def test_moe_layer_matches_jax(activation, jax_dispatch, port_dispatch):
    """Output, aux loss and the gradients of x, the gate weight, w1, b1, w2
    and b2 for the loss ``sum(out * r) + aux``."""
    ja, tl = _layer_pair(activation, jax_dispatch, port_dispatch, seed=17)
    rng = np.random.RandomState(19)
    x = rng.randn(2, 24, 32).astype(np.float32)
    r = rng.randn(2, 24, 32).astype(np.float32)

    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = ja(jx)
    ((jy * paddle.to_tensor(r)).sum() + ja.aux_loss).backward()
    tx = torch.tensor(x, requires_grad=True)
    ty = tl(tx)
    ((ty * torch.from_numpy(r)).sum() + tl.aux_loss).backward()

    np.testing.assert_allclose(ty.detach().numpy(), _np(jy.numpy()),
                               rtol=LAYER_FWD_TOL, atol=LAYER_FWD_TOL)
    np.testing.assert_allclose(tl.aux_loss.item(), float(ja.aux_loss),
                               rtol=1e-6)
    grads = {"x": (tx.grad, jx.grad),
             "gate.weight": (tl.gate.weight.grad, ja.gate.weight.grad)}
    jexp = dict(ja.experts.named_parameters())
    for name, p in tl.experts.named_parameters():
        grads[f"experts.{name}"] = (p.grad, jexp[name].grad)
    for name, (t, j) in grads.items():
        np.testing.assert_allclose(t.numpy(), _np(j.numpy()),
                                   rtol=LAYER_GRAD_RTOL,
                                   atol=LAYER_GRAD_ATOL, err_msg=name)
    assert float(tl.gate.weight.grad.abs().max()) > 0


def test_moe_layer_bf16_matches_jax():
    """One bf16 forward of the port's grouped route against the JAX
    layer in bf16."""
    ja, tl = _layer_pair("swiglu", "capacity", "grouped", seed=23,
                         dtype="bfloat16")
    x = np.random.RandomState(29).randn(48, 32).astype(np.float32)
    ref = _np(ja(paddle.to_tensor(x).astype("bfloat16")).astype(
        "float32").numpy())
    with torch.no_grad():
        out = tl(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= BF16_OF_MAX * np.abs(ref).max(), err


def test_auto_dispatch_follows_the_kernel_widths():
    """``"auto"`` takes the grouped route when every expert width is one the
    kernels take, on the CPU as well."""
    def layer(d, h):
        return MoELayer(GShardGate(d, 4, device="cpu"),
                        MLPExperts(4, d, h, activation="swiglu",
                                   device="cpu"))
    assert layer(64, 128).use_grouped()
    assert layer(256, 384).use_grouped()
    assert not layer(64, 200).use_grouped()      # > 128, not a multiple
    assert not layer(60, 128).use_grouped()      # not a multiple of 8
    moe = layer(64, 128)
    moe(torch.randn(2, 8, 64))
    assert moe.expert_load is not None and int(moe.expert_load.sum()) == 32
    with pytest.raises(ValueError, match="dispatch"):
        MoELayer(moe.gate, moe.experts, dispatch="grouped_interpret")


# ------------------------------------------------------------- the slice
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            moe_num_experts=4, moe_topk=2, moe_every=2, dtype="float32")


def _model_pair(seed, **over):
    paddle.seed(seed)
    jm = JaxMoELlama(JaxMoEConfig(**TINY, **over))
    tm = MoELlamaForCausalLM(MoELlamaConfig(**TINY, **over), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (2, 24))
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = -100
    return ids, labels


def test_moe_llama_logits_and_loss_match_jax():
    """The JAX weights load as they are (gate and expert tensors copied,
    linear weights transposed); logits, and the loss with the aux term by
    both loss paths."""
    jm, tm = _model_pair(31)
    assert [l.use_moe for l in tm.layers] == [False, True, False, True]
    assert len(tm.moe_layers()) == 2
    ids, labels = _batch(32)
    jids, jlab = paddle.to_tensor(ids), paddle.to_tensor(labels)
    tids, tlab = torch.from_numpy(ids), torch.from_numpy(labels)
    with torch.no_grad():
        np.testing.assert_allclose(tm(tids).numpy(), _np(jm(jids).numpy()),
                                   rtol=1e-4, atol=1e-5)
        for fused in (False, True):
            jm.config.fused_loss = tm.config.fused_loss = fused
            jloss, _ = jm(jids, labels=jlab)
            tloss, tlogits = tm(tids, labels=tlab)
            np.testing.assert_allclose(float(tloss), float(jloss),
                                       rtol=LOSS_RTOL)
            assert (tlogits is None) == fused
    aux = sum(float(m.aux_loss) for m in tm.moe_layers())
    assert aux > 0


def test_moe_llama_train_step_matches_jax():
    """10 TrainStep steps with AdamW (lr 3e-4 as ``bench.py``'s MoE row, wd
    0.1, clip 1.0, fused loss) against the JAX TrainStep: the loss at every
    step and every parameter after the run. The port takes the grouped
    route (the kernels' plain versions), the JAX model its CPU capacity
    route; Adam's normalised steps carry their different summation orders
    forward, about 2e-5 per 1e-3 of learning rate after 10 steps."""
    jm, tm = _model_pair(41, fused_loss=True)
    ids, labels = _batch(42)
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=3e-4, weight_decay=0.1, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=3e-4, weight_decay=0.1, parameters=tm.parameters()),
        clip_norm=1.0)
    assert all(m.use_grouped() for m in tm.moe_layers())
    jl, tl = [], []
    for _ in range(10):
        jl.append(float(jstep(paddle.to_tensor(ids),
                              paddle.to_tensor(labels))))
        tl.append(float(tstep(torch.from_numpy(ids),
                              torch.from_numpy(labels))))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] - 0.1
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        ours = p.detach().numpy()
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            ours = ours.T
        np.testing.assert_allclose(ours, jparams[name], atol=PARAM_ATOL,
                                   err_msg=name)


def test_moe_llama_gate_gets_gradient():
    """The gate weight of every MoE layer receives a non-zero gradient (the
    routing weights and the aux loss), and so does every expert tensor."""
    _, tm = _model_pair(51, fused_loss=True)
    ids, labels = _batch(52)
    loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    for moe in tm.moe_layers():
        assert float(moe.gate.weight.grad.abs().max()) > 0
        for name, p in moe.experts.named_parameters():
            assert float(p.grad.abs().max()) > 0, name
