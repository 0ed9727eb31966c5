"""The port's AMP (``paddle_tpu_torch.amp``) against the JAX package's on
the CPU: the output dtype of each op under O1 and O2 from f32 and bf16
inputs, GradScaler's scale sequence and skips under injected infs, one
unscale however often ``unscale_`` is called, the unscaled gradients at a
scale that is not a power of two (f32 gradients equal; bf16 ones JAX's f32
gradient rounded once to bf16, as the port unscales in the gradient's
dtype), float32 gradients for float32 leaves under O1, and ``decorate``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.fused.cross_entropy import \
    fused_linear_cross_entropy as j_fused_ce
from paddle_tpu.ops.fused.flash_attention import flash_attention as j_flash
from paddle_tpu.ops.fused.rope import apply_rotary_position_embedding as \
    j_rope
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.llama import _shifted_cross_entropy
from paddle_tpu_torch.nn.functional import rms_norm, swiglu
from paddle_tpu_torch.ops.fused.cross_entropy import \
    fused_linear_cross_entropy as t_fused_ce
from paddle_tpu_torch.ops.fused.flash_attention import flash_attention
from paddle_tpu_torch.ops.fused.rope import apply_rotary_position_embedding

torch.set_num_threads(2)

J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arr(shape, seed, dtype):
    a = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    return (paddle.to_tensor(jnp.asarray(a).astype(J_DT[dtype])),
            torch.from_numpy(a).to(T_DT[dtype]))


def _ids(shape, high, seed):
    a = np.random.RandomState(seed).randint(0, high, shape)
    return paddle.to_tensor(a), torch.from_numpy(a)


def _ops(dt):
    """name -> (JAX call, port call) on the same inputs in dtype ``dt``."""
    x = _arr((4, 8), 0, dt)
    w = _arr((8, 6), 1, dt)
    sq = _arr((8, 8), 2, dt)
    nw = _arr((8,), 3, dt)
    q = _arr((1, 16, 2, 8), 4, dt)
    k = _arr((1, 16, 2, 8), 5, dt)
    v = _arr((1, 16, 2, 8), 6, dt)
    cs = _arr((16, 8), 7, "float32")
    ids, lab = _ids((4,), 6, 8), _ids((4,), 6, 9)
    emb = _arr((10, 8), 10, dt)
    return {
        "linear": (lambda: JF.linear(x[0], w[0]),
                   lambda: F.linear(x[1], w[1].t())),
        "matmul": (lambda: paddle.matmul(x[0], sq[0]),
                   lambda: x[1] @ sq[1]),
        "add": (lambda: x[0] + x[0], lambda: x[1] + x[1]),
        "exp": (lambda: paddle.exp(x[0]), lambda: torch.exp(x[1])),
        "softmax": (lambda: JF.softmax(x[0]), lambda: F.softmax(x[1], -1)),
        "sum": (lambda: paddle.sum(x[0]), lambda: torch.sum(x[1])),
        "embedding": (lambda: JF.embedding(ids[0], emb[0]),
                      lambda: F.embedding(ids[1], emb[1])),
        "rms_norm": (lambda: JF.rms_norm(x[0], nw[0], epsilon=1e-6),
                     lambda: rms_norm(x[1], nw[1], 1e-6)),
        "swiglu": (lambda: JF.swiglu(x[0], x[0]),
                   lambda: swiglu(x[1], x[1])),
        "apply_rope": (lambda: j_rope(q[0], cs[0], cs[0]),
                       lambda: apply_rotary_position_embedding(q[1], cs[1],
                                                               cs[1])),
        "flash_attention": (lambda: j_flash(q[0], k[0], v[0], causal=True),
                            lambda: flash_attention(q[1], k[1], v[1],
                                                    causal=True)),
        # the Llama loss: JAX's one cross_entropy op over the shifted
        # logits, the port's _shifted_cross_entropy
        "cross_entropy": (lambda: JF.cross_entropy(
            JF.linear(x[0], w[0])[:-1], lab[0][1:]),
            lambda: _shifted_cross_entropy(
                F.linear(x[1], w[1].t())[None], lab[1][None])),
        "fused_linear_cross_entropy": (
            lambda: j_fused_ce(x[0], w[0], lab[0]),
            lambda: t_fused_ce(x[1], w[1].t(), lab[1])),
    }


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("in_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_op_output_dtypes_match_jax(level, in_dtype):
    """Each op's output dtype under ``auto_cast(level)`` equals JAX's, and
    f32 outputs agree with JAX within bf16 rounding."""
    ops = _ops(in_dtype)
    for name, (jcall, tcall) in ops.items():
        with jamp.auto_cast(level=level):
            jout = jcall()
        with tamp.auto_cast(level=level):
            tout = tcall()
        assert _dtype_name(tout) == str(jout.dtype), (name, level, in_dtype)
        np.testing.assert_allclose(
            tout.detach().float().numpy(),
            np.asarray(jout._data, np.float32), rtol=2e-2, atol=2e-2,
            err_msg=name)
    # outside auto_cast nothing is cast
    for name, (_, tcall) in ops.items():
        out = tcall()
        if name not in ("cross_entropy", "fused_linear_cross_entropy"):
            assert _dtype_name(out) == in_dtype, name


def test_custom_lists_and_nesting():
    """``custom_white_list`` adds an op to O1's casts, ``custom_black_list``
    takes one out (and keeps it f32 under O2); an inner ``auto_cast(False)``
    turns the casts off; the state comes back on exit."""
    x = torch.randn(4, 8)
    with tamp.auto_cast(custom_white_list=["exp"]):
        assert torch.exp(x).dtype == torch.bfloat16
        with tamp.auto_cast(enable=False):
            assert F.linear(x, torch.randn(6, 8)).dtype == torch.float32
        assert F.linear(x, torch.randn(6, 8)).dtype == torch.bfloat16
    with tamp.auto_cast(custom_black_list=["linear"]):
        assert F.linear(x, torch.randn(6, 8)).dtype == torch.float32
    with tamp.auto_cast(level="O2", custom_black_list=["add"]):
        assert (x.bfloat16() + x.bfloat16()).dtype == torch.float32
    assert not tamp.amp_state().enabled
    assert F.linear(x, torch.randn(6, 8)).dtype == torch.float32


def test_f32_leaves_get_f32_gradients():
    """Under O1 an f32 weight feeds a bf16 product; its gradient is f32 and
    equals JAX's within bf16 rounding."""
    x = np.random.RandomState(0).standard_normal((5, 8)).astype(np.float32)
    w = np.random.RandomState(1).standard_normal((8, 3)).astype(np.float32)
    tw = torch.nn.Parameter(torch.from_numpy(w.T.copy()))
    jw = JParameter(jnp.asarray(w), name="w")
    with tamp.auto_cast():
        y = F.linear(torch.from_numpy(x), tw)
    assert y.dtype == torch.bfloat16
    (y.float() ** 2).sum().backward()
    assert tw.grad.dtype == torch.float32
    with jamp.auto_cast():
        jy = JF.linear(paddle.to_tensor(x), jw)
    (jy.astype("float32") ** 2).sum().backward()
    assert jw.grad.dtype == jnp.float32
    np.testing.assert_allclose(tw.grad.numpy().T, np.asarray(jw.grad._data),
                               rtol=2e-2, atol=2e-2)


def _scaler_pair(**kw):
    return jamp.GradScaler(**kw), tamp.GradScaler(**kw)


def _param_pair(dtype, seed=0):
    a = np.random.RandomState(seed).standard_normal((6, 5)).astype(np.float32)
    jp = JParameter(jnp.asarray(a).astype(J_DT[dtype]), name="p")
    tp = torch.nn.Parameter(torch.from_numpy(a).to(T_DT[dtype]))
    return jp, tp


def _set_grad(jp, tp, g):
    jp.grad = JTensor(jnp.asarray(g).astype(jp._data.dtype))
    tp.grad = torch.from_numpy(g.copy()).to(tp.dtype)


def test_scale_sequence_under_injected_infs():
    """A dynamic scaler (2**10, incr every 2 good steps, decr after 2 bad
    ones) over 16 steps with an inf at steps 2, 3, 8, 9 and 10 and a nan at
    13: the scale after each update, the good/bad counters, and the
    parameters (a step with an inf or nan is skipped) match JAX's."""
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
              decr_every_n_nan_or_inf=2)
    js, ts = _scaler_pair(**kw)
    jp, tp = _param_pair("float32")
    jo = jopt.SGD(learning_rate=0.1, parameters=[jp])
    to = topt.SGD(learning_rate=0.1, parameters=[tp], device="cpu")
    rng = np.random.RandomState(3)
    jscales, tscales = [], []
    for i in range(16):
        g = rng.standard_normal((6, 5)).astype(np.float32) * ts._scale
        if i in (2, 3, 8, 9, 10):
            g[1, 2] = np.inf
        if i == 13:
            g[0, 0] = np.nan
        _set_grad(jp, tp, g)
        before = tp.detach().clone()
        js.step(jo)
        ts.step(to)
        assert torch.equal(tp.detach(), before) == (i in (2, 3, 8, 9, 10,
                                                          13)), i
        js.update()
        ts.update()
        jscales.append(js.get_loss_scaling())
        tscales.append(ts.get_loss_scaling())
    assert tscales == jscales
    assert len(set(tscales)) > 3
    assert ts.state_dict() == js.state_dict()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._data),
                               rtol=1e-6)


def test_no_double_unscale_and_minimize():
    """``unscale_`` then ``step`` divides once; a second ``unscale_`` before
    the step does nothing; ``minimize`` runs backward, step, update and
    clear_grad."""
    ts = tamp.GradScaler(init_loss_scaling=8.0)
    jp, tp = _param_pair("float32")
    to = topt.SGD(learning_rate=1.0, parameters=[tp], device="cpu")
    g = np.full((6, 5), 8.0, np.float32)
    _set_grad(jp, tp, g)
    ts.unscale_(to)
    ts.unscale_(to)
    assert torch.equal(tp.grad, torch.ones(6, 5))
    before = tp.detach().clone()
    ts.step(to)
    assert torch.equal(tp.detach(), before - 1.0)
    # the step forgets the unscale: the next step's gradients are unscaled
    _set_grad(jp, tp, g)
    ts.step(to)
    assert torch.equal(tp.detach(), before - 2.0)
    to.clear_grad()
    loss = (tp * 3.0).sum()
    ts.minimize(to, ts.scale(loss))
    assert tp.grad is None
    torch.testing.assert_close(tp.detach(), before - 5.0, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scale", [2.0 ** 12, 1000.0])
def test_unscaled_gradients_against_jax(dtype, scale):
    """The gradients after ``unscale_``: f32 ones equal JAX's bit for bit at
    any scale; bf16 ones are JAX's f32 gradient rounded to bf16, which is
    JAX's exactly when the scale is a power of two."""
    js, ts = _scaler_pair(init_loss_scaling=scale)
    jp, tp = _param_pair(dtype)
    g = (np.random.RandomState(4).standard_normal((6, 5)) * 300).astype(
        np.float32)
    _set_grad(jp, tp, g)
    jo = jopt.SGD(learning_rate=0.1, parameters=[jp])
    to = topt.SGD(learning_rate=0.1, parameters=[tp], device="cpu")
    js.unscale_(jo)
    ts.unscale_(to)
    ref = np.array(jp.grad._data)
    assert ref.dtype == np.float32 and tp.grad.dtype == T_DT[dtype]
    ours = tp.grad.float().numpy()
    rounded = torch.from_numpy(ref).to(T_DT[dtype]).float().numpy()
    np.testing.assert_array_equal(ours, rounded)
    if dtype == "float32" or scale == 2.0 ** 12:
        np.testing.assert_array_equal(ours, ref)
    else:
        assert not np.array_equal(ours, ref)


def test_found_inf_stays_on_the_device():
    """The flag is a tensor from ``unscale_`` to the optimizer's step (the
    optimizer sees it during ``step`` only); ``update`` reads it."""
    ts = tamp.GradScaler(init_loss_scaling=4.0)
    _, tp = _param_pair("float32")
    to = topt.AdamW(learning_rate=0.1, parameters=[tp], device="cpu")
    seen = []
    real_apply = to._apply

    def spy(pg):
        seen.append(to._found_inf)
        real_apply(pg)

    to._apply = spy
    tp.grad = torch.full((6, 5), float("inf"))
    ts.step(to)
    assert isinstance(seen[0], torch.Tensor) and int(seen[0]) == 1
    assert to._found_inf is None
    ts.update()
    assert ts.get_loss_scaling() == 2.0


def test_decorate_o2():
    """``decorate`` at O2 casts the model's parameters and floating buffers
    to bf16 in place (the optimizer's parameter objects stay) and turns on
    master weights, as JAX's does."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=1, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=16,
                      dtype="float32")
    m = LlamaForCausalLM(cfg, device="cpu")
    params = list(m.parameters())
    opt = topt.AdamW(learning_rate=1e-3, parameters=params)
    m2, opt2 = tamp.decorate(m, opt, level="O2")
    assert m2 is m and opt2 is opt and opt._multi_precision
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    assert [id(p) for p in m.parameters()] == [id(p) for p in params]
    assert m.model.rope_cos.dtype == torch.bfloat16
    ms = tamp.decorate([m], level="O1")
    assert ms == [m]
    _, opt3 = tamp.decorate(m, topt.AdamW(parameters=params),
                            master_weight=False)
    assert not opt3._multi_precision


@pytest.mark.parametrize("policy", ["full", "save_dots"])
@pytest.mark.parametrize("level", ["O1", "O2"])
def test_recompute_under_auto_cast(level, policy):
    """A recomputed layer runs again in the backward, outside the forward's
    ``auto_cast``; it must be cast as in the forward: the loss and every
    gradient bit for bit those of the model without recompute."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    def run(recompute):
        cfg = LlamaConfig(vocab_size=128, hidden_size=32,
                          intermediate_size=64, num_hidden_layers=2,
                          num_attention_heads=4, num_key_value_heads=2,
                          max_position_embeddings=32, dtype="float32",
                          recompute=recompute, recompute_policy=policy)
        m = LlamaForCausalLM(cfg, device="cpu", seed=3)
        ids = torch.from_numpy(
            np.random.RandomState(1).randint(0, 128, (2, 16)))
        with tamp.auto_cast(level=level):
            loss, _ = m(ids, labels=ids)
        loss.backward()
        return loss, [p.grad for p in m.parameters()]

    ref, got = run(False), run(True)
    assert torch.equal(ref[0], got[0])
    for a, b in zip(ref[1], got[1]):
        assert torch.equal(a, b)
