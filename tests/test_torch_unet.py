"""The UNet slice against the JAX package on the CPU, in f32: the timestep
embedding, ``Conv2D``, ``interpolate`` (nearest), ``silu``, a
``ResnetBlock``, a ``CrossAttnBlock`` with sq != sk (forward and
gradients), the whole ``unet-tiny`` (output and every parameter's
gradient), 5 ``TrainStep`` losses at ``tests/test_unet.py``'s inputs and
learning rate, a second config with attention at two levels (head dims 16
and 32: skips concatenated across three levels, attention on the up path),
the ``state_dict`` keys one for one, and the optimizer state carried over.
Weights go from JAX to the port through ``load_paddle_tpu_state`` (linear
weights transposed, conv and norm weights as they are).

Tolerances: outputs and gradients within 1e-5 of max |JAX| (f32 sums in
other orders; a gradient within 1e-5 of the larger of its own max |JAX|
and 1e-2 of the largest gradient, for the ones that are rounding noise,
such as the key projections'); the TrainStep's losses within 1e-4
relative (Adam carries the rounding from step to step); the timestep
embedding within 2e-4 (its test says why)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models import unet as junet
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (UNET_PRESETS, UNet2DConditionModel,
                                     UNetConfig,
                                     load_paddle_tpu_optimizer_state,
                                     load_paddle_tpu_state,
                                     timestep_embedding)
from paddle_tpu_torch.models import unet as tunet
from paddle_tpu_torch.nn import Conv2D
from paddle_tpu_torch.nn import functional as TF

torch.set_num_threads(2)

TOL = 1e-5
# attention at levels 1 and 2 (head dims 16 and 32), three levels of skips
TWO_LEVELS = dict(block_out_channels=(32, 64, 128), attn_levels=(1, 2),
                  layers_per_block=1, num_attention_heads=4,
                  cross_attention_dim=64, norm_num_groups=8)


def _arr(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy() if hasattr(x, "numpy") else x)


def _load(tmod, jmod):
    load_paddle_tpu_state(tmod, {k: np.asarray(v.numpy())
                                 for k, v in jmod.state_dict().items()})


def _near(got, want, tol=TOL, floor=1e-30):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err / scale:.2e} of max |JAX|"


def _grads_near(tm, jm):
    """Every parameter's gradient against JAX's (linear weights
    transposed), each within TOL of the larger of its own max |JAX| and
    the largest gradient's 1e-2."""
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    top = max(float(np.abs(g).max()) for g in jgrads.values())
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        if name.rsplit(".", 1)[0] in linear and name.endswith(".weight"):
            g = g.T
        _near(g, jgrads[name], floor=1e-2 * top)


def _unet_pair(over, seed):
    paddle.seed(seed)
    jm = junet.UNet2DConditionModel(junet.UNetConfig(**over))
    tm = UNet2DConditionModel(UNetConfig(**over), device="cpu", seed=seed)
    _load(tm, jm)
    return jm, tm


def _unet_inputs(ctx_dim, seed, b=2, hw=16, ctx_len=8):
    x = _arr((b, 4, hw, hw), seed)
    t = np.asarray([10, 500][:b], np.int32)
    ctx = _arr((b, ctx_len, ctx_dim), seed + 1)
    return x, t, ctx


def test_timestep_embedding_matches_jax():
    """Within 2e-4: the two libraries' f32 ``exp`` of a frequency may differ
    by an ulp, which t = 999 multiplies into the angle (an f32 angle near
    999 is itself only good to 6e-5)."""
    t = np.asarray([0, 1, 7, 423, 999], np.int32)
    for dim in (32, 192):
        _near(timestep_embedding(torch.from_numpy(t), dim),
              junet.timestep_embedding(paddle.to_tensor(t), dim), tol=2e-4)
    assert timestep_embedding(torch.from_numpy(t), 8).dtype == torch.float32


@pytest.mark.parametrize("kw", [
    dict(kernel_size=3, padding=1), dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=1, bias_attr=False)], ids=["3x3", "stride2", "1x1"])
def test_conv2d_matches_jax(kw):
    paddle.seed(3)
    jc = jnn.Conv2D(6, 10, **kw)
    tc = Conv2D(6, 10, **kw)
    assert tc.weight.shape == (10, 6, kw["kernel_size"], kw["kernel_size"])
    assert (tc.bias is None) == (kw.get("bias_attr") is False)
    _load(tc, jc)
    x = _arr((2, 6, 9, 9), 4)
    _near(tc(torch.from_numpy(x)), jc(paddle.to_tensor(x)))


def test_conv2d_init():
    g = torch.Generator().manual_seed(0)
    c = Conv2D(8, 16, 3, generator=g)
    again = Conv2D(8, 16, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c.weight, again.weight)
    assert float(c.weight.detach().abs().max()) <= (6 / 72) ** 0.5
    assert torch.equal(c.bias, torch.zeros(16))


@pytest.mark.parametrize("kw", [
    dict(scale_factor=2), dict(size=[12, 20]), dict(size=[5, 4])],
    ids=["factor2", "size_up", "size_down"])
def test_interpolate_matches_jax(kw):
    x = _arr((2, 3, 8, 10), 5)
    _near(TF.interpolate(torch.from_numpy(x), mode="nearest", **kw),
          JF.interpolate(paddle.to_tensor(x), mode="nearest", **kw))


def test_interpolate_refuses_other_modes():
    with pytest.raises(NotImplementedError, match="nearest"):
        TF.interpolate(torch.zeros(1, 1, 2, 2), scale_factor=2,
                       mode="bilinear")


def test_silu_matches_jax():
    x = _arr((4, 33), 6, 3.0)
    _near(TF.silu(torch.from_numpy(x)), JF.silu(paddle.to_tensor(x)))


def test_resnet_block_matches_jax():
    paddle.seed(7)
    jb = junet.ResnetBlock(16, 32, 48, 8)
    tb = tunet.ResnetBlock(16, 32, 48, 8, torch.Generator(),
                           dtype=torch.float32)
    _load(tb, jb)
    x, temb = _arr((2, 16, 8, 8), 8), _arr((2, 48), 9)
    jout = jb(paddle.to_tensor(x), paddle.to_tensor(temb))
    _near(tb(torch.from_numpy(x), torch.from_numpy(temb)), jout)


def test_cross_attn_block_matches_jax():
    """sq = 36 spatial tokens against 11 context tokens, 4 heads of 8:
    output and every gradient."""
    paddle.seed(10)
    jb = junet.CrossAttnBlock(32, 4, 24)
    tb = tunet.CrossAttnBlock(32, 4, 24, torch.Generator(),
                              dtype=torch.float32)
    _load(tb, jb)
    x, ctx = _arr((2, 36, 32), 11), _arr((2, 11, 24), 12)
    jout = jb(paddle.to_tensor(x), paddle.to_tensor(ctx))
    tout = tb(torch.from_numpy(x), torch.from_numpy(ctx))
    _near(tout, jout)
    dy = _arr(jout.shape, 13)
    (jout * paddle.to_tensor(dy)).sum().backward()
    (tout * torch.from_numpy(dy)).sum().backward()
    _grads_near(tb, jb)


@pytest.mark.parametrize("over", [
    UNET_PRESETS["unet-tiny"].__dict__, TWO_LEVELS],
    ids=["unet-tiny", "two-attention-levels"])
def test_unet_output_and_gradients_match_jax(over):
    jm, tm = _unet_pair(dict(over), 14)
    x, t, ctx = _unet_inputs(over["cross_attention_dim"], 15, hw=8)
    jx = [paddle.to_tensor(a) for a in (x, t, ctx)]
    tx = [torch.from_numpy(a) for a in (x, t, ctx)]
    jout, tout = jm(*jx), tm(*tx)
    _near(tout, jout)
    dy = _arr(tuple(jout.shape), 16)
    (jout * paddle.to_tensor(dy)).sum().backward()
    (tout * torch.from_numpy(dy)).sum().backward()
    _grads_near(tm, jm)


def test_unet_train_step_matches_jax():
    """5 TrainStep steps (AdamW lr 2e-3) of ``unet-tiny`` on the fixed-noise
    MSE loss at ``tests/test_unet.py:49-65``'s inputs: the loss at every
    step."""
    over = dict(UNET_PRESETS["unet-tiny"].__dict__)
    jm, tm = _unet_pair(over, 0)
    x, t, ctx = _unet_inputs(over["cross_attention_dim"], 17)
    noise = _arr(x.shape, 18)
    jnoise, tnoise = paddle.to_tensor(noise), torch.from_numpy(noise)
    jstep = JTrainStep(jm, lambda p, *_: ((p - jnoise) ** 2).mean(),
                       jopt.AdamW(learning_rate=2e-3,
                                  parameters=jm.parameters()))
    tstep = TrainStep(tm, lambda p, *_: ((p - tnoise) ** 2).mean(),
                      topt.AdamW(learning_rate=2e-3,
                                 parameters=tm.parameters()))
    jl, tl = [], []
    for _ in range(5):
        jl.append(float(jstep(*(paddle.to_tensor(a) for a in (x, t, ctx)))))
        tl.append(float(tstep(*(torch.from_numpy(a) for a in (x, t, ctx)))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_state_dict_keys_match_jax():
    """Keys and shapes one for one, in order, for ``unet-tiny`` and the
    two-level config (sdxl-small is held at full size on the card, by
    ``chip_smoke.py``'s parameter count); the samplers' placeholders at the
    last level hold nothing."""
    for name in ("unet-tiny", "two-levels"):
        over = TWO_LEVELS if name == "two-levels" \
            else UNET_PRESETS[name].__dict__
        paddle.seed(0)
        jm = junet.UNet2DConditionModel(junet.UNetConfig(**over))
        tm = UNet2DConditionModel(UNetConfig(**over), device="cpu")
        js = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
        linear = {n for n, m in tm.named_modules()
                  if isinstance(m, torch.nn.Linear)}
        ts = {k: tuple(v.shape)[::-1] if k.rsplit(".", 1)[0] in linear
              and k.endswith(".weight") else tuple(v.shape)
              for k, v in tm.state_dict().items()}
        assert list(ts) == list(js) and ts == js   # same order too
    assert isinstance(tm.downsamplers[-1], torch.nn.Identity)
    assert isinstance(tm.upsamplers[-1], torch.nn.Identity)
    assert not any(k.startswith(("downsamplers.2.", "upsamplers.2."))
                   for k in tm.state_dict())


def test_bf16_model_holds_bf16_parameters():
    cfg = UNetConfig(**{**UNET_PRESETS["unet-tiny"].__dict__,
                        "dtype": "bfloat16"})
    m = UNet2DConditionModel(cfg, device="cpu")
    assert {p.dtype for p in m.parameters()} == {torch.bfloat16}
    x, t, ctx = _unet_inputs(cfg.cross_attention_dim, 19, b=1, hw=8)
    out = m(torch.from_numpy(x).bfloat16(), torch.from_numpy(t),
            torch.from_numpy(ctx).bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (1, 4, 8, 8)
    assert bool(torch.isfinite(out.float()).all())


def test_optimizer_state_crosses_from_jax():
    """``unet-tiny`` trained 2 eager AdamW steps in JAX, its model and
    optimizer state carried into the port: linear weights' moments
    transposed, conv weights' (4-D) and norms' as they are, bit for bit;
    then 2 more steps in each package agree."""
    over = dict(UNET_PRESETS["unet-tiny"].__dict__)
    paddle.seed(20)
    jm = junet.UNet2DConditionModel(junet.UNetConfig(**over))
    jo = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    x, t, ctx = _unet_inputs(over["cross_attention_dim"], 21)
    noise = _arr(x.shape, 22)
    jin = [paddle.to_tensor(a) for a in (x, t, ctx)]
    tin = [torch.from_numpy(a) for a in (x, t, ctx)]

    def jstep():
        loss = ((jm(*jin) - paddle.to_tensor(noise)) ** 2).mean()
        loss.backward()
        jo.step()
        jo.clear_grad()
        return float(loss)

    for _ in range(2):
        jstep()
    tm = UNet2DConditionModel(UNetConfig(**over), device="cpu")
    _load(tm, jm)
    to = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    names = [n for n, _ in jm.named_parameters()]
    jsd = {k: (np.asarray(v.numpy()) if isinstance(v, JTensor) else v)
           for k, v in jo.state_dict().items()}
    load_paddle_tpu_optimizer_state(to, tm, jsd, names)
    tparams = dict(tm.named_parameters())
    tindex = {id(p): i for i, p in enumerate(to._parameter_list)}
    tsd = to.state_dict()
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for key, value in jsd.items():
        if not key.startswith("p"):
            continue
        i, entry = key.split(".", 1)
        name = names[int(i[1:])]
        ours = _np(tsd[f"p{tindex[id(tparams[name])]}.{entry}"])
        ref = np.asarray(value)
        if name.rsplit(".", 1)[0] in linear and ref.ndim == 2:
            ref = ref.T
        np.testing.assert_array_equal(ours, ref.astype(np.float32),
                                      err_msg=key)
    jl, tl = [], []
    for _ in range(2):
        jl.append(jstep())
        loss = ((tm(*tin) - torch.from_numpy(noise)) ** 2).mean()
        loss.backward()
        to.step()
        to.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
