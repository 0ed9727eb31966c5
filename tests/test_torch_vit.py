"""The ViT slice against the JAX package on the CPU, in f32: the loss layers
and ``gelu``, the transformer layers (``MultiHeadAttention`` self and
cross with a cache, encoder layers pre- and post-norm, the encoder of deep
copies, decoder layers, ``Transformer``), then ``vit-tiny``'s logits and
gradients and 12 ``TrainStep`` losses. Weights go from JAX to the port
through ``load_paddle_tpu_state`` (linear weights transposed).

Tolerances: layer outputs, logits and gradients within 1e-5 of max |JAX|
(f32 sums in other orders); losses within 1e-5 relative; the TrainStep's
within 1e-4 (Adam carries the rounding from step to step)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JTrainStep
from paddle_tpu.models.vit import VIT_PRESETS as JVIT
from paddle_tpu.models.vit import VisionTransformer as JViT
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (VIT_PRESETS, VisionTransformer,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TOL = 1e-5


def _arr(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _load(tmod, jmod):
    load_paddle_tpu_state(tmod, {k: np.asarray(v.numpy())
                                 for k, v in jmod.state_dict().items()})


def _near(got, want, tol=TOL, floor=1e-30):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy() if hasattr(want, "numpy") else want)
    scale = max(float(np.abs(want).max()), floor)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err / scale:.2e} of max |JAX|"


# --------------------------------------------------------------- losses
def _loss_inputs():
    logits = _arr((6, 5), 0)
    probs = 1 / (1 + np.exp(-_arr((6, 5), 1)))
    lbl = np.random.RandomState(2).randint(0, 5, 6).astype(np.int64)
    lbl[3] = -100
    bin_lbl = np.random.RandomState(3).randint(0, 2, (6, 5)).astype(
        np.float32)
    sign = np.where(np.random.RandomState(4).rand(6) > 0.5, 1.0,
                    -1.0).astype(np.float32)
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    other = _arr((6, 5), 6)
    soft = np.exp(other) / np.exp(other).sum(-1, keepdims=True)
    return {
        "CrossEntropyLoss": ((), (logits, lbl)),
        "MSELoss": ((), (logits, probs)),
        "L1Loss": ((), (logits, probs)),
        "NLLLoss": ((), (logp.astype(np.float32), lbl)),
        "BCELoss": ((), (probs.astype(np.float32), bin_lbl)),
        "BCEWithLogitsLoss": ((), (logits, bin_lbl)),
        "SmoothL1Loss": ((), (logits, probs)),
        "KLDivLoss": (("batchmean",), (logp.astype(np.float32),
                                       soft.astype(np.float32))),
        "MarginRankingLoss": ((0.1,), (logits[:, 0], logits[:, 1], sign)),
        "CosineEmbeddingLoss": ((0.2,), (logits, probs, sign)),
        "HingeEmbeddingLoss": ((), (logits[:, 0], sign)),
        "TripletMarginLoss": ((), (logits, probs, _arr((6, 5), 5))),
    }


LOSSES = sorted(_loss_inputs())


@pytest.mark.parametrize("name", LOSSES)
def test_loss_layers_match_jax(name):
    args, inputs = _loss_inputs()[name]
    want = getattr(jnn, name)(*args)(*[paddle.to_tensor(a) for a in inputs])
    got = getattr(tnn, name)(*args)(*[torch.from_numpy(np.asarray(a))
                                      for a in inputs])
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


def test_cross_entropy_options_match_jax():
    logits, lbl = _arr((6, 5), 7), np.array([0, 4, -100, 2, 1, 3])
    w = np.abs(_arr((5,), 8)) + 0.1
    soft = np.abs(_arr((6, 5), 9))
    soft = (soft / soft.sum(-1, keepdims=True)).astype(np.float32)
    cases = [dict(weight=w), dict(label_smoothing=0.1),
             dict(reduction="sum"), dict(reduction="none")]
    for kw in cases:
        jkw = {k: paddle.to_tensor(v) if k == "weight" else v
               for k, v in kw.items()}
        tkw = {k: torch.from_numpy(v) if k == "weight" else v
               for k, v in kw.items()}
        want = JF.cross_entropy(paddle.to_tensor(logits),
                                paddle.to_tensor(lbl), **jkw)
        got = TF.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(lbl), **tkw)
        _near(got, want)
    _near(TF.cross_entropy(torch.from_numpy(logits), torch.from_numpy(soft),
                           soft_label=True),
          JF.cross_entropy(paddle.to_tensor(logits), paddle.to_tensor(soft),
                           soft_label=True))


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(approximate):
    x = _arr((4, 33), 10, 3.0)
    _near(TF.gelu(torch.from_numpy(x), approximate=approximate),
          JF.gelu(paddle.to_tensor(x), approximate=approximate), 1e-6)


def test_attention_dropout_refuses():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="dropout"):
        TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1)
    out = TF.scaled_dot_product_attention(q, q, q, dropout_p=0.1,
                                          training=False)
    assert out.shape == q.shape
    mha = tnn.MultiHeadAttention(16, 2, dropout=0.1)
    with pytest.raises(NotImplementedError):
        mha(torch.zeros(1, 4, 16))
    mha.eval()
    assert mha(torch.zeros(1, 4, 16)).shape == (1, 4, 16)


# ----------------------------------------------------- transformer layers
def test_multi_head_attention_matches_jax():
    paddle.seed(11)
    jself, tself = jnn.MultiHeadAttention(32, 4), tnn.MultiHeadAttention(32,
                                                                         4)
    _load(tself, jself)
    q = _arr((2, 7, 32), 12)
    _near(tself(torch.from_numpy(q)), jself(paddle.to_tensor(q)))
    jm = jnn.MultiHeadAttention(32, 4, kdim=24, vdim=20)
    tm = tnn.MultiHeadAttention(32, 4, kdim=24, vdim=20)
    _load(tm, jm)
    k, v = _arr((2, 9, 24), 13), _arr((2, 9, 20), 14)
    _near(tm(*map(torch.from_numpy, (q, k, v))),
          jm(*map(paddle.to_tensor, (q, k, v))))
    # an incremental cache: the projected key/value appended along seq
    jc = jm.gen_cache(paddle.to_tensor(k), paddle.to_tensor(v))
    tc = tm.gen_cache(torch.from_numpy(k), torch.from_numpy(v))
    jo, jc2 = jm(paddle.to_tensor(q), paddle.to_tensor(k),
                 paddle.to_tensor(v), cache=jc)
    to, tc2 = tm(*map(torch.from_numpy, (q, k, v)), cache=tc)
    _near(to, jo)
    _near(tc2.k, jc2.k)
    assert tc2.k.shape == (2, 18, 4, 8)
    assert tself.gen_cache(torch.from_numpy(q)).k.shape == (2, 0, 4, 8)


@pytest.mark.parametrize("pre", [True, False])
def test_encoder_matches_jax(pre):
    paddle.seed(15)
    jl = jnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=pre)
    je = jnn.TransformerEncoder(jl, 3, norm=jnn.LayerNorm(32))
    tl = tnn.TransformerEncoderLayer(32, 4, 64, dropout=0.0,
                                     activation="gelu",
                                     normalize_before=pre)
    te = tnn.TransformerEncoder(tl, 3, norm=tnn.LayerNorm(32))
    _load(te, je)
    x = _arr((2, 11, 32), 16)
    _near(te(torch.from_numpy(x)), je(paddle.to_tensor(x)))
    # deep copies: every layer starts from the first's weights
    assert all(torch.equal(a, b) for a, b in zip(
        te.layers[0].parameters(), te.layers[2].parameters()))
    assert te.layers[0].linear1.weight is not te.layers[2].linear1.weight


def test_decoder_and_transformer_match_jax():
    paddle.seed(17)
    jt = jnn.Transformer(32, 4, 2, 2, 48, dropout=0.0,
                         normalize_before=True)
    tt = tnn.Transformer(32, 4, 2, 2, 48, dropout=0.0,
                         normalize_before=True)
    _load(tt, jt)
    src, tgt = _arr((2, 9, 32), 18), _arr((2, 6, 32), 19)
    mask = jnn.Transformer.generate_square_subsequent_mask(6)
    tmask = tnn.Transformer.generate_square_subsequent_mask(6)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask.numpy()))
    _near(tt(torch.from_numpy(src), torch.from_numpy(tgt), tgt_mask=tmask),
          jt(paddle.to_tensor(src), paddle.to_tensor(tgt), tgt_mask=mask))
    paddle.seed(20)
    jd = jnn.TransformerDecoderLayer(32, 4, 48, dropout=0.0)
    td = tnn.TransformerDecoderLayer(32, 4, 48, dropout=0.0)
    _load(td, jd)
    _near(td(torch.from_numpy(tgt), torch.from_numpy(src)),
          jd(paddle.to_tensor(tgt), paddle.to_tensor(src)))


# ------------------------------------------------------------------ ViT
def _vit_pair(seed):
    paddle.seed(seed)
    jm = JViT(JVIT["vit-tiny"])
    tm = VisionTransformer(VIT_PRESETS["vit-tiny"], device="cpu")
    _load(tm, jm)
    return jm, tm


def _images(seed, n=4):
    x = _arr((n, 3, 32, 32), seed)
    y = np.random.RandomState(seed + 1).randint(0, 10, n).astype(np.int64)
    return x, y


def test_vit_config_and_init():
    cfg = VIT_PRESETS["vit-l16"]
    assert (cfg.num_patches, cfg.hidden_size // cfg.num_attention_heads) \
        == (196, 64)
    assert cfg.num_params() == 304_326_632
    tiny = VisionTransformer(VIT_PRESETS["vit-tiny"], device="cpu", seed=3)
    assert sum(p.numel() for p in tiny.parameters()) == \
        VIT_PRESETS["vit-tiny"].num_params()
    again = VisionTransformer(VIT_PRESETS["vit-tiny"], device="cpu", seed=3)
    assert all(torch.equal(a, b) for a, b in zip(tiny.parameters(),
                                                 again.parameters()))
    assert float(tiny.cls_token.abs().max()) <= 0.04
    bf = VisionTransformer(VIT_PRESETS["vit-tiny"].__class__(
        **{**VIT_PRESETS["vit-tiny"].__dict__, "dtype": "bfloat16"}),
        device="cpu")
    assert {p.dtype for p in bf.parameters()} == {torch.bfloat16}


def test_vit_logits_and_gradients_match_jax():
    jm, tm = _vit_pair(21)
    x, y = _images(22)
    _near(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))
    jloss, _ = jm(paddle.to_tensor(x), labels=paddle.to_tensor(y))
    jloss.backward()
    tloss, _ = tm(torch.from_numpy(x), labels=torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL)
    jgrads = {n: np.asarray(p.grad.numpy()) for n, p in
              jm.named_parameters()}
    # the key bias gets no gradient in exact arithmetic (softmax is blind to
    # a per-row constant): its rounding noise is held to 1e-5 of the
    # largest gradient
    floor = max(float(np.abs(g).max()) for g in jgrads.values())
    linear = {n for n, m in tm.named_modules()
              if isinstance(m, torch.nn.Linear)}
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        if name.rsplit(".", 1)[0] in linear and name.endswith(".weight"):
            g = g.T
        _near(g, jgrads[name], floor=floor)


def test_vit_h14_shaped_logits_match_jax():
    """ViT-H14's widths (patch 14, hidden 1280, 16 heads of 80: the mma.sync
    flash kernels' head dim on the card) at 2 layers, 224-pixel images (257
    tokens) and 10 classes: the logits."""
    from paddle_tpu.models.vit import ViTConfig as JCfg
    from paddle_tpu_torch.models import ViTConfig

    over = dict(JVIT["vit-h14"].__dict__, num_hidden_layers=2,
                num_classes=10)
    paddle.seed(41)
    jm = JViT(JCfg(**over))
    tm = VisionTransformer(ViTConfig(**over), device="cpu")
    assert tm.config.hidden_size // tm.config.num_attention_heads == 80
    assert tm.config.num_patches + 1 == 257
    _load(tm, jm)
    x = _arr((2, 3, 224, 224), 42)
    _near(tm(torch.from_numpy(x)), jm(paddle.to_tensor(x)))

def test_vit_train_step_matches_jax():
    """12 TrainStep steps (AdamW lr 1e-3, wd 0.05, clip 1.0) on one batch:
    the loss at every step."""
    jm, tm = _vit_pair(31)
    x, y = _images(32, n=8)
    jstep = JTrainStep(jm, None, jopt.AdamW(
        learning_rate=1e-3, weight_decay=0.05, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=1e-3, weight_decay=0.05, parameters=tm.parameters()),
        clip_norm=1.0)
    jl, tl = [], []
    for _ in range(12):
        jl.append(float(jstep(paddle.to_tensor(x), paddle.to_tensor(y))))
        tl.append(float(tstep(torch.from_numpy(x), torch.from_numpy(y))))
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0] - 0.5
