"""The Paddle training loop through the port against the JAX package on the
CPU: a DataLoader over a numpy dataset (shuffled, two process workers) ->
``auto_cast`` -> ``scaler.scale(loss).backward()`` -> ``scaler.step(opt)``
(AdamW with a ``ClipGradByGlobalNorm`` and a ``LinearWarmup`` over a cosine
decay) -> ``scaler.update()`` -> ``opt.clear_grad()`` -> ``sched.step()``,
on a 4-layer tiny Llama for 10 steps, at O1 (an f32 model) and O2
(``amp.decorate``: a bf16 model with f32 masters), with the JAX model's
weights loaded into the port.

Tolerance: each step's loss within 5e-3 relative of JAX's (the largest
gap seen at these seeds is 7e-4). The two packages round their bf16
products and attention differently (bf16 keeps 8 bits: 2^-8 = 3.9e-3 a
rounding), and Adam's normalised steps carry that into the weights from the
first step on. In f32 the same loop agrees to 1e-4
(``test_torch_training.py``). At this size bf16 moves the losses as little
(O1 against no autocast: 6e-4), so the first step also checks the dtypes
that reach each layer.

Also: ``state_dict`` after step 5 of the O2 run (model, optimizer with its
scheduler, scaler) into a fresh model, optimizer, scheduler and scaler,
which run steps 6-10 on the same batches bit for bit as the uninterrupted
run; and ``jit.TrainStep`` stepping with an ``LRScheduler`` against JAX's.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.io as jio
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
STEPS = 10
LOSS_RTOL = 5e-3
# the output dtype of each kind of module under each level: the products
# in bf16; the norms are black-listed (f32 under O2, the f32 model's under
# O1); the embedding is cast under O2 only
LAYER_DTYPES = {
    "O1": {"Linear": torch.bfloat16, "RMSNorm": torch.float32,
           "Embedding": torch.float32},
    "O2": {"Linear": torch.bfloat16, "RMSNorm": torch.float32,
           "Embedding": torch.bfloat16},
}


class Rows:
    """Seeded token rows: a map-style numpy dataset."""

    def __init__(self, n=8, seq=24, seed=31):
        self.rows = np.random.RandomState(seed).randint(
            0, TINY["vocab_size"], (n, seq))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def make_pair(seed, **over):
    paddle.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY, **over))
    tm = LlamaForCausalLM(LlamaConfig(**TINY, **over), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy()) for k, v in
                               jm.state_dict().items()})
    return jm, tm


def schedule(m):
    return m.lr.LinearWarmup(m.lr.CosineAnnealingDecay(3e-3, 10), 3, 0.0,
                             3e-3)


def batches(m, seed, steps=STEPS):
    """``steps`` batches of 2 rows from a shuffled DataLoader with two
    process workers, seeded with ``seed``."""
    loader = m.DataLoader(Rows(), batch_size=2, shuffle=True, num_workers=2)
    np.random.seed(seed)
    out = []
    while len(out) < steps:
        out.extend(loader)
    return out[:steps]


def run_jax(jm, level, ids_list):
    sched = schedule(jopt)
    opt = jopt.AdamW(learning_rate=sched, parameters=jm.parameters(),
                     weight_decay=0.1,
                     grad_clip=jnn.ClipGradByGlobalNorm(1.0))
    scaler = jamp.GradScaler(init_loss_scaling=2.0 ** 10)
    if level == "O2":
        jm, opt = jamp.decorate(jm, opt, level="O2")
    losses = []
    for ids in ids_list:
        with jamp.auto_cast(level=level):
            loss, _ = jm(ids, labels=ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses


def port_loop(tm, level, decorate=True):
    sched = schedule(topt)
    opt = topt.AdamW(learning_rate=sched, parameters=tm.parameters(),
                     weight_decay=0.1,
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    scaler = tamp.GradScaler(init_loss_scaling=2.0 ** 10)
    if level == "O2" and decorate:
        tamp.decorate(tm, opt, level="O2")
    return sched, opt, scaler


def layer_dtypes(tm):
    """Forward hooks that record each module kind's output dtypes; returns
    the record and the hooks' handles."""
    seen, handles = {}, []
    for mod in tm.modules():
        kind = type(mod).__name__
        if kind in ("Linear", "RMSNorm", "Embedding"):
            handles.append(mod.register_forward_hook(
                lambda m, a, out, kind=kind: seen.setdefault(kind, set()).add(
                    out.dtype)))
    return seen, handles


def port_steps(tm, level, sched, opt, scaler, ids_list):
    losses = []
    for ids in ids_list:
        with tamp.auto_cast(level=level):
            loss, _ = tm(ids, labels=ids)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("level,fused_loss", [("O1", True), ("O2", True),
                                              ("O2", False)])
def test_paddle_loop_matches_jax(level, fused_loss):
    """10 steps of the loop in both packages on the same DataLoader
    batches: the losses within LOSS_RTOL, falling; under O2 the port's
    parameters are bf16 with f32 masters that moved, under O1 f32."""
    jm, tm = make_pair(21, fused_loss=fused_loss)
    jb = batches(jio, 41)
    tb = batches(tio, 41)
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(np.asarray(j.numpy()), t.numpy())
    jl = run_jax(jm, level, jb)
    sched, opt, scaler = port_loop(tm, level)
    start = {n: p.detach().float().clone() for n, p in tm.named_parameters()}
    seen, handles = layer_dtypes(tm)
    tl = port_steps(tm, level, sched, opt, scaler, tb[:1])
    for h in handles:
        h.remove()
    assert seen == {k: {v} for k, v in LAYER_DTYPES[level].items()}
    tl += port_steps(tm, level, sched, opt, scaler, tb[1:])
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] - 0.1
    want = torch.bfloat16 if level == "O2" else torch.float32
    assert all(p.dtype == want for p in tm.parameters())
    assert opt._step_count == STEPS and scaler.get_loss_scaling() == 2.0 ** 10
    if level == "O2":
        masters = [k for k in opt.state_dict() if k.endswith(".master")]
        assert len(masters) == len(list(tm.parameters()))
        for i, (name, p) in enumerate(tm.named_parameters()):
            m = opt.state_dict()[f"p{i}.master"]
            assert m.dtype == torch.float32
            assert torch.equal(p.detach(), m.to(torch.bfloat16))
            if not name.endswith("norm.weight"):
                assert not torch.equal(m, start[name]), name


def test_o2_resume_is_bit_exact():
    """The O2 loop's state after step 5 (model, optimizer with its
    scheduler, scaler) into a fresh model, optimizer, scheduler and scaler:
    steps 6-10 on the same batches give the same losses and parameters bit
    for bit."""
    _, tm = make_pair(23)
    ids_list = batches(tio, 43)
    sched, opt, scaler = port_loop(tm, "O2")
    full = port_steps(tm, "O2", sched, opt, scaler, ids_list[:5])
    saved = ({k: v.clone() for k, v in tm.state_dict().items()},
             {k: (v.clone() if isinstance(v, torch.Tensor) else v)
              for k, v in opt.state_dict().items()},
             scaler.state_dict())
    full += port_steps(tm, "O2", sched, opt, scaler, ids_list[5:])
    _, tm2 = make_pair(99)
    sched2, opt2, scaler2 = port_loop(tm2, "O2")
    tm2.load_state_dict(saved[0])
    opt2.set_state_dict(saved[1])
    scaler2.load_state_dict(saved[2])
    assert sched2.last_epoch == 5 and opt2._step_count == 5
    resumed = port_steps(tm2, "O2", sched2, opt2, scaler2, ids_list[5:])
    assert resumed == full[5:]
    for (n, p), (_, q) in zip(tm.named_parameters(), tm2.named_parameters()):
        assert torch.equal(p, q), n


def test_train_step_with_lr_scheduler():
    """``jit.TrainStep`` reads ``opt.get_lr()`` on every call: 10 steps with
    a ``LinearWarmup`` stepped after each, against JAX's TrainStep (f32:
    loss rtol 1e-4, parameters 1e-5)."""
    jm, tm = make_pair(25)
    ids = np.random.RandomState(26).randint(0, TINY["vocab_size"], (2, 24))
    jsched = jopt.lr.LinearWarmup(1e-3, 4, 0.0, 1e-3)
    tsched = topt.lr.LinearWarmup(1e-3, 4, 0.0, 1e-3)
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=jsched, weight_decay=0.1, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, topt.AdamW(
        learning_rate=tsched, weight_decay=0.1, parameters=tm.parameters()),
        clip_norm=1.0)
    jl, tl, lrs = [], [], []
    for _ in range(STEPS):
        lrs.append(tstep._opt.get_lr())
        jl.append(float(jstep(paddle.to_tensor(ids), paddle.to_tensor(ids))))
        tl.append(float(tstep(torch.from_numpy(ids), torch.from_numpy(ids))))
        jsched.step()
        tsched.step()
    assert lrs[:5] == [0.0, 2.5e-4, 5e-4, 7.5e-4, 1e-3]
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    for name, p in tm.named_parameters():
        a = p.detach().numpy()
        a = a.T if name.endswith(("_proj.weight", "lm_head.weight")) else a
        np.testing.assert_allclose(a, jparams[name], atol=1e-5, err_msg=name)
