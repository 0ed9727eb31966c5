"""``paddle_tpu_torch.Model`` (``hapi/``) against ``paddle_tpu.Model`` on the
CPU, the same weights in both (``load_paddle_tpu_state``) and the same
seeded numpy datasets, shuffled by the same numpy draws.

Held equal to JAX: ``fit``'s per-step losses and metrics (through a
recording callback) and its history, ``evaluate``, ``predict`` (stacked
and per batch), predictions after ``save`` -> ``load``, ``num_iters``,
``EarlyStopping`` (when it stops, ``best_model``), the LR scheduler stepped
by the default ``LRScheduler`` callback and by an epoch one, ``summary``;
an MLP and ``vit-tiny`` in f32 (losses within 1e-5 relative: the packages
sum in other orders, and Adam carries that from step to step; arrays
within that of their largest value), and
``vit-tiny`` in bf16 under ``auto_cast(level="O2")`` (within 2e-2: bf16
keeps 8 bits, and the two round their products and sums differently).

Held to itself (where the port is Paddle's hapi and JAX is not, see
``hapi/model.py``): the optimizer's state after ``fit`` and in ``.pdopt``,
a resume from the epoch-1 checkpoint bit for bit equal to the unbroken
run, ``grad_clip`` applied, and the network's mode restored."""

import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.hapi as jhapi
import paddle_tpu.metric as jmetric
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.models.vit import VisionTransformer as JViT
from paddle_tpu.models.vit import ViTConfig as JViTConfig
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import hapi as thapi
from paddle_tpu_torch import metric as tmetric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (VIT_PRESETS, ViTConfig,
                                     VisionTransformer,
                                     load_paddle_tpu_state)

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
BF16_RTOL = 2e-2


class Blobs:
    """Seeded features whose class is decided by a random linear map."""

    def __init__(self, n=64, seed=0):
        rng = np.random.RandomState(seed)
        self.x = rng.randn(n, 8).astype(np.float32)
        w = rng.randn(8, 3).astype(np.float32)
        self.y = (self.x @ w).argmax(-1).astype(np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class Images:
    """Seeded images: 10 prototypes plus noise; the label is the
    prototype."""

    def __init__(self, n=32, size=32, seed=0):
        rng = np.random.RandomState(seed)
        protos = rng.standard_normal((10, 3, size, size)).astype(np.float32)
        self.y = rng.randint(0, 10, n).astype(np.int64)
        self.x = (protos[self.y] + 0.5 * rng.standard_normal(
            (n, 3, size, size))).astype(np.float32)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


def _recorder(base):
    class Record(base):
        def __init__(self):
            super().__init__()
            self.steps, self.evals = [], []

        def on_train_batch_end(self, step, logs=None):
            self.steps.append(dict(logs))

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))

    return Record()


def _mlp_pair(seed=3):
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 32), jnn.ReLU(), jnn.Linear(32, 3))
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(),
                               torch.nn.Linear(32, 3))
    load_paddle_tpu_state(tnet, {k: np.asarray(v.numpy())
                                 for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _vit_pair(cfg, seed=4):
    paddle.seed(seed)
    jnet = JViT(JViTConfig(**cfg.__dict__))
    tnet = VisionTransformer(cfg, device="cpu")
    load_paddle_tpu_state(tnet, {k: np.asarray(v.numpy())
                                 for k, v in jnet.state_dict().items()})
    return jnet, tnet


def _models(jnet, tnet, lr=1e-2, topk=(1, 2), jsched=None, tsched=None):
    jm, tm = jhapi.Model(jnet), ptt.Model(tnet)
    jm.prepare(jopt.AdamW(learning_rate=jsched or lr,
                          parameters=jnet.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy(topk=topk))
    tm.prepare(topt.AdamW(learning_rate=tsched or lr,
                          parameters=tnet.parameters()),
               tnn.CrossEntropyLoss(), tmetric.Accuracy(topk=topk))
    return jm, tm


def _fit_both(jm, tm, train, held, seed=7, jcb=(), tcb=(), **kw):
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    np.random.seed(seed)
    jh = jm.fit(train, held, callbacks=[jrec, *jcb], verbose=0, **kw)
    np.random.seed(seed)
    th = tm.fit(train, held, callbacks=[trec, *tcb], verbose=0, **kw)
    return jh, th, jrec, trec


def _close(t, j, rtol):
    if isinstance(j, (list, tuple)):
        assert len(t) == len(j)
        for a, b in zip(t, j):
            _close(a, b, rtol)
    elif isinstance(j, dict):
        assert t.keys() == j.keys()
        for k in j:
            _close(t[k], j[k], rtol)
    elif j is None:
        assert t is None
    else:
        scale = float(np.max(np.abs(np.asarray(j, np.float64))))
        np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * scale)


def test_mlp_fit_evaluate_predict_match_jax():
    jnet, tnet = _mlp_pair()
    jm, tm = _models(jnet, tnet)
    train, held = Blobs(64, 0), Blobs(24, 1)
    jh, th, jrec, trec = _fit_both(jm, tm, train, held, batch_size=8,
                                   epochs=2, shuffle=True)
    assert len(trec.steps) == 16
    _close([s["loss"] for s in trec.steps], [s["loss"] for s in jrec.steps],
           LOSS_RTOL)
    _close([s["acc_top1"] for s in trec.steps],
           [s["acc_top1"] for s in jrec.steps], 1e-12)
    _close(th, jh, LOSS_RTOL)
    assert th["loss"][-1] < trec.steps[0]["loss"]
    _close(tm.evaluate(held, batch_size=8, verbose=0),
           jm.evaluate(held, batch_size=8, verbose=0), LOSS_RTOL)
    for stack in (True, False):
        _close(tm.predict(held, batch_size=10, stack_outputs=stack),
               jm.predict(held, batch_size=10, stack_outputs=stack),
               LOSS_RTOL)
    out = tm.predict(held, batch_size=10, stack_outputs=True)
    assert out[0].shape == (24, 3) and out[0].dtype == np.float32
    info = tm.summary()
    assert info == jm.summary()


def test_save_load_and_resume(tmp_path):
    """``save_dir`` writes ``0``, ``1`` and ``final`` (``.pdparams`` and
    ``.pdopt``); a fresh Model loaded from ``final`` predicts bit for bit,
    and JAX's loaded from its own ``final`` agrees; the port's ``.pdopt``
    holds the moments and the step count (JAX's has ``_step_count`` 0).
    Epoch 2 resumed from ``0`` gives the unbroken run's losses and
    parameters bit for bit."""
    jnet, tnet = _mlp_pair(5)
    jm, tm = _models(jnet, tnet)
    train, held = Blobs(48, 2), Blobs(16, 3)
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    np.random.seed(0)
    jm.fit(train, batch_size=8, epochs=2, shuffle=False, save_dir=jdir,
           verbose=0)
    trec = _recorder(thapi.Callback)
    tm.fit(train, batch_size=8, epochs=2, shuffle=False, save_dir=tdir,
           verbose=0, callbacks=[trec])
    for name in ("0", "1", "final"):
        for ext in (".pdparams", ".pdopt"):
            assert os.path.exists(os.path.join(tdir, name + ext))
    tsd = ptt.load(os.path.join(tdir, "final.pdopt"))
    assert tsd["_step_count"] == 12 and "p0.moment1" in tsd
    assert paddle.load(os.path.join(jdir, "final.pdopt"))[
        "_step_count"] == 0
    want = tm.predict(held, batch_size=16, stack_outputs=True)[0]

    _, fresh = _mlp_pair(99)
    _, tm2 = _models(_mlp_pair(99)[0], fresh)
    tm2.load(os.path.join(tdir, "final"))
    np.testing.assert_array_equal(
        tm2.predict(held, batch_size=16, stack_outputs=True)[0], want)
    jfresh, _ = _mlp_pair(99)
    jm2, _ = _models(jfresh, _mlp_pair(99)[1])
    jm2.load(os.path.join(jdir, "final"))
    _close(want, jm2.predict(held, batch_size=16, stack_outputs=True)[0],
           LOSS_RTOL)

    _, resumed = _mlp_pair(77)
    _, tm3 = _models(_mlp_pair(77)[0], resumed)
    tm3.load(os.path.join(tdir, "0"))
    assert tm3._optimizer._step_count == 6
    rec3 = _recorder(thapi.Callback)
    tm3.fit(train, batch_size=8, epochs=1, shuffle=False, verbose=0,
            callbacks=[rec3])
    assert [s["loss"] for s in rec3.steps] == \
        [s["loss"] for s in trec.steps[6:]]
    for a, b in zip(tnet.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_num_iters_early_stopping_and_schedulers(tmp_path):
    # num_iters: 5 steps over 4-step epochs, then stop
    jnet, tnet = _mlp_pair(8)
    jm, tm = _models(jnet, tnet)
    jh, th, jrec, trec = _fit_both(jm, tm, Blobs(32, 4), None, batch_size=8,
                                   epochs=3, num_iters=5)
    assert len(trec.steps) == len(jrec.steps) == 5
    _close(th, jh, LOSS_RTOL)
    # EarlyStopping on eval_loss, which rises from the second epoch on
    # here (the MLP overfits 32 rows): training stops after patience 1
    jnet, tnet = _mlp_pair(9)
    jm, tm = _models(jnet, tnet)
    tdir = str(tmp_path / "es")
    jh, th, jrec, trec = _fit_both(
        jm, tm, Blobs(32, 5), Blobs(16, 6), batch_size=8, epochs=6,
        jcb=[jhapi.EarlyStopping("eval_loss", patience=1,
                                 verbose=0)],
        tcb=[thapi.EarlyStopping("eval_loss", patience=1,
                                 verbose=0)],
        save_dir=tdir)
    assert len(th["loss"]) == len(jh["loss"]) == 2
    _close(th, jh, LOSS_RTOL)
    assert os.path.exists(os.path.join(tdir, "best_model.pdparams"))
    # an LR scheduler: stepped each batch by fit's own LRScheduler and
    # each epoch by a second one
    jnet, tnet = _mlp_pair(10)
    js, ts = (m.lr.StepDecay(0.05, step_size=3, gamma=0.5)
              for m in (jopt, topt))
    jm, tm = _models(jnet, tnet, jsched=js, tsched=ts)
    jh, th, jrec, trec = _fit_both(
        jm, tm, Blobs(32, 7), None, batch_size=8, epochs=2,
        jcb=[jhapi.LRScheduler(by_step=False, by_epoch=True)],
        tcb=[thapi.LRScheduler(by_step=False, by_epoch=True)])
    assert ts.last_epoch == js.last_epoch == 10
    _close([s["loss"] for s in trec.steps], [s["loss"] for s in jrec.steps],
           LOSS_RTOL)


def test_grad_clip_and_modes():
    """The optimizer's ``grad_clip`` acts in ``fit`` (Paddle's hapi; JAX's
    step ignores it): equal to a hand-written loop with the same clip, and
    other than without it. ``eval_batch`` / ``predict_batch`` put the
    network's mode back; ``train_batch`` returns the loss and metrics."""
    data = Blobs(16, 11)

    def run(clip, by_hand):
        _, net = _mlp_pair(12)
        opt = topt.AdamW(learning_rate=1e-2, parameters=net.parameters(),
                         grad_clip=tnn.ClipGradByGlobalNorm(1e-2)
                         if clip else None)
        if by_hand:
            for i in range(0, 16, 8):
                x = torch.from_numpy(data.x[i:i + 8])
                y = torch.from_numpy(data.y[i:i + 8])
                torch.nn.functional.cross_entropy(net(x), y).backward()
                opt.step()
                opt.clear_grad()
        else:
            m = ptt.Model(net)
            m.prepare(opt, tnn.CrossEntropyLoss())
            m.fit(data, batch_size=8, shuffle=False, verbose=0)
        return [p.detach().clone() for p in net.parameters()]

    clipped = run(True, False)
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-7)
               for a, b in zip(clipped, run(True, True)))
    assert not all(torch.equal(a, b)
                   for a, b in zip(clipped, run(False, False)))

    _, net = _mlp_pair(13)
    m = ptt.Model(net)
    m.prepare(topt.AdamW(parameters=net.parameters()),
              tnn.CrossEntropyLoss(), tmetric.Accuracy())
    net.train()
    lv, (acc,) = m.train_batch(data.x[:8], data.y[:8])
    assert isinstance(lv, float) and 0.0 <= acc <= 1.0
    m.eval_batch(data.x[:8], data.y[:8])
    assert net.training
    net.eval()
    outs = m.predict_batch(data.x[:4])
    assert not net.training and outs[0].shape == (4, 3)
    with pytest.raises(TypeError):
        m.prepare(None, None, metrics=[object()])


def test_vit_tiny_fit_matches_jax_f32():
    jnet, tnet = _vit_pair(VIT_PRESETS["vit-tiny"])
    jm, tm = _models(jnet, tnet, lr=1e-3, topk=(1, 5))
    train, held = Images(32, seed=0), Images(16, seed=1)
    jh, th, jrec, trec = _fit_both(jm, tm, train, held, batch_size=8,
                                   epochs=1, shuffle=True)
    _close([s["loss"] for s in trec.steps], [s["loss"] for s in jrec.steps],
           LOSS_RTOL)
    _close(th, jh, LOSS_RTOL)
    _close(tm.predict(held, batch_size=8, stack_outputs=True),
           jm.predict(held, batch_size=8, stack_outputs=True), 1e-4)


def test_vit_tiny_bf16_o2_fit_matches_jax():
    """A bf16 vit-tiny through ``Model.fit`` from f32 images under
    ``auto_cast(level="O2")`` in both packages (JAX's conv refuses the f32
    images against bf16 weights without it)."""
    cfg = ViTConfig(**{**VIT_PRESETS["vit-tiny"].__dict__,
                       "dtype": "bfloat16"})
    jnet, tnet = _vit_pair(cfg, seed=6)
    assert {p.dtype for p in tnet.parameters()} == {torch.bfloat16}
    jm, tm = _models(jnet, tnet, lr=1e-3, topk=(1, 5))
    train = Images(32, seed=2)
    jrec, trec = _recorder(jhapi.Callback), _recorder(thapi.Callback)
    np.random.seed(1)
    with jamp.auto_cast(level="O2"):
        jm.fit(train, batch_size=8, epochs=1, verbose=0, callbacks=[jrec])
    np.random.seed(1)
    with tamp.auto_cast(level="O2"):
        tm.fit(train, batch_size=8, epochs=1, verbose=0, callbacks=[trec])
    tl = [s["loss"] for s in trec.steps]
    assert np.all(np.isfinite(tl)) and len(tl) == 4
    _close(tl, [s["loss"] for s in jrec.steps], BF16_RTOL)
    with tamp.auto_cast(level="O2"):
        out = tm.predict(Images(8, seed=3), batch_size=8)[0][0]
    assert out.shape == (8, 10) and np.all(np.isfinite(out))
