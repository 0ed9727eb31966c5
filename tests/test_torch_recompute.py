"""Per-layer recompute (``paddle_tpu_torch/framework/recompute.py``) on the
CPU: the ``"full"`` and ``"save_dots"`` policies against no recompute on
the tiny f32 Llama (the same loss bit for bit, gradients within 1e-6),
what each policy runs again in the backward (counted by a
``TorchDispatchMode``: ``save_dots`` runs the flash forward once a layer
and no matrix product beyond the backward's own, ``full`` runs both
again), the JAX ``TrainStep`` with ``recompute_policy="save_dots"`` against
the port's over 20 steps and the MoE-Llama's dense-layer recompute over 10
(the tolerances of ``test_torch_training.py`` and ``test_torch_moe.py``),
and ``recompute_sequential`` against the JAX one.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.framework.recompute import \
    recompute_sequential as jax_recompute_sequential
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.models import MoELlamaConfig as JaxMoEConfig
from paddle_tpu.models import MoELlamaForCausalLM as JaxMoELlama
from paddle_tpu_torch.framework import (recompute, recompute_sequential,
                                        resolve_policy)
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     MoELlamaConfig, MoELlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.optimizer import AdamW

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
MOE_TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                num_hidden_layers=4, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=64,
                moe_num_experts=4, moe_topk=2, moe_every=2, dtype="float32")
GRAD_ATOL = 1e-6
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
FLASH_FWD = torch.ops.paddle_tpu_torch.flash_fwd.default
MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
      torch.ops.aten.bmm.default)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_layout(name, a):
    return a.T if name.endswith("_proj.weight") or name == "lm_head.weight" \
        else a


def _batch(seed, vocab, shape=(2, 24)):
    """Token ids and labels as ``test_torch_training.py``'s ``batch``."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, shape)
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = labels[1, 18] = -100
    return torch.from_numpy(ids), torch.from_numpy(labels)


class _Ops(TorchDispatchMode):
    """Counts the dispatcher's operators run under it."""

    def __init__(self):
        super().__init__()
        self.count = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count[func] += 1
        return func(*args, **(kwargs or {}))


def _model(policy, seed=3):
    over = {} if policy is None else dict(recompute=True,
                                          recompute_policy=policy)
    return LlamaForCausalLM(LlamaConfig(**TINY, **over), device="cpu",
                            seed=seed)


def _loss_and_grads(model, ids, labels):
    fwd, bwd = _Ops(), _Ops()
    with fwd:
        loss, _ = model(ids, labels=labels)
    params = list(model.parameters())
    with bwd:
        grads = torch.autograd.grad(loss, params)
    return loss, grads, fwd.count, bwd.count


def test_recompute_policies_match_no_recompute_and_save_what_they_say():
    ids, labels = _batch(4, TINY["vocab_size"])
    layers = TINY["num_hidden_layers"]
    base_loss, base_grads, base_fwd, base_bwd = _loss_and_grads(
        _model(None), ids, labels)
    assert base_fwd[FLASH_FWD] == layers and base_bwd[FLASH_FWD] == 0
    base_mm = sum(base_bwd[op] for op in MM)
    for policy in ("full", "save_dots"):
        loss, grads, fwd, bwd = _loss_and_grads(_model(policy), ids, labels)
        assert torch.equal(loss, base_loss), policy
        for g, r in zip(grads, base_grads):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=GRAD_ATOL,
                                       err_msg=policy)
        assert fwd[FLASH_FWD] == layers
        mm = sum(bwd[op] for op in MM)
        if policy == "save_dots":
            # the flash forward and every product kept: nothing of them
            # runs again in the backward
            assert bwd[FLASH_FWD] == 0 and mm == base_mm
        else:
            assert bwd[FLASH_FWD] == layers and mm > base_mm


def test_recompute_only_in_training():
    """``eval()`` turns per-layer recompute off, as the JAX model's
    ``self.training`` test does: the forward keeps its graph as usual."""
    model = _model("full")
    model.eval()
    ids, labels = _batch(5, TINY["vocab_size"])
    loss, grads, fwd, bwd = _loss_and_grads(model, ids, labels)
    assert bwd[FLASH_FWD] == 0


def test_resolve_policy():
    assert resolve_policy(None) is None and resolve_policy("full") is None

    def mine(ctx, op, *args, **kwargs):
        return None

    assert resolve_policy(mine) is mine
    assert callable(resolve_policy("save_dots"))
    with pytest.raises(ValueError, match="unknown recompute policy"):
        resolve_policy("save_everything")
    with pytest.raises(ValueError, match="unknown recompute policy"):
        recompute(torch.nn.Identity(), torch.ones(2, requires_grad=True),
                  policy="dots")


@pytest.mark.parametrize("segments", [1, 2])
def test_recompute_sequential_matches_jax(segments):
    """Three linear layers with a tanh between, recomputed in ``segments``
    runs: the output and the input's gradient against the JAX
    ``recompute_sequential`` on its eager tape. That tape threads the
    parameters of a Layer only, and a chunk of a list is a closure, so the
    JAX weights get no gradient there: the port's are held against plain
    autograd without recompute."""
    paddle.seed(6)
    jl = [jnn.Linear(8, 8) for _ in range(3)]
    tl = [torch.nn.Linear(8, 8) for _ in range(3)]
    with torch.no_grad():
        for j, t in zip(jl, tl):
            t.weight.copy_(torch.tensor(np.asarray(j.weight.numpy()).T))
            t.bias.copy_(torch.tensor(np.asarray(j.bias.numpy())))
    jfns = [jl[0], jnn.Tanh(), jl[1], jnn.Tanh(), jl[2]]
    tfns = [tl[0], torch.nn.Tanh(), tl[1], torch.nn.Tanh(), tl[2]]
    x = np.random.RandomState(7).standard_normal((4, 8)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jy = jax_recompute_sequential({"segments": segments}, jfns, jx)
    paddle.sum(jy * jy).backward()
    tx = torch.from_numpy(x).requires_grad_()
    ty = recompute_sequential({"segments": segments}, tfns, tx)
    (ty * ty).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy.numpy()),
                               atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.numpy()),
                               atol=1e-5)
    ours = [g for t in tl for g in (t.weight.grad, t.bias.grad)]
    for t in tl:
        t.zero_grad()
    y = torch.from_numpy(x)
    for f in tfns:
        y = f(y)
    (y * y).sum().backward()
    for g, t in zip(ours, [g for t in tl for g in (t.weight.grad,
                                                     t.bias.grad)]):
        assert torch.equal(g, t)


def _trajectories(jm, tm, ids, labels, steps, lr):
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=lr, weight_decay=0.1, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=lr, weight_decay=0.1, parameters=tm.parameters()),
        clip_norm=1.0)
    jl, tl = [], []
    for _ in range(steps):
        jl.append(float(jstep(paddle.to_tensor(ids.numpy()),
                              paddle.to_tensor(labels.numpy()))))
        tl.append(float(tstep(ids, labels)))
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] - 0.1
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_port_layout(name, p.detach().numpy()),
                                   jparams[name], atol=PARAM_ATOL,
                                   err_msg=name)


def test_save_dots_train_step_matches_jax():
    """20 TrainStep steps of the tiny Llama with ``recompute=True,
    recompute_policy="save_dots"`` in both frameworks (AdamW lr 1e-3, wd
    0.1, clip 1.0, fused loss), on the weights and batch of
    ``test_torch_training.py``'s ``test_train_step_matches_jax`` (seeds 21
    and 22), where its tolerances hold the two frameworks without
    recompute; and the port's parameters after the run equal, bit for bit,
    those of the same run without recompute."""
    over = dict(recompute=True, recompute_policy="save_dots",
                fused_loss=True)
    paddle.seed(21)
    jm = JaxLlama(JaxLlamaConfig(**TINY, **over))
    tm = LlamaForCausalLM(LlamaConfig(**TINY, **over), device="cpu")
    plain = LlamaForCausalLM(LlamaConfig(**TINY, fused_loss=True),
                             device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    load_paddle_tpu_state(plain, _state(jm))
    ids, labels = _batch(22, TINY["vocab_size"])
    _trajectories(jm, tm, ids, labels, 20, 1e-3)
    step = TrainStep(plain, None, AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=plain.parameters()),
        clip_norm=1.0)
    for _ in range(20):
        step(ids, labels)
    for (name, p), q in zip(tm.named_parameters(), plain.parameters()):
        assert torch.equal(p, q), name


def test_moe_dense_layer_recompute_matches_jax():
    """10 TrainStep steps of the tiny MoE-Llama with ``recompute=True``
    (``full``: the dense layers recomputed, the MoE layers not) against
    the JAX TrainStep, as ``test_torch_moe.py`` holds it without; the
    backward runs the dense layers' flash forward again, not the MoE
    layers'."""
    over = dict(recompute=True, recompute_policy="full", fused_loss=True)
    paddle.seed(10)
    jm = JaxMoELlama(JaxMoEConfig(**MOE_TINY, **over))
    tm = MoELlamaForCausalLM(MoELlamaConfig(**MOE_TINY, **over),
                             device="cpu")
    load_paddle_tpu_state(tm, _state(jm))
    ids, labels = _batch(11, MOE_TINY["vocab_size"])
    loss, _, fwd, bwd = _loss_and_grads(tm, ids, labels)
    dense = sum(not layer.use_moe for layer in tm.layers)
    assert fwd[FLASH_FWD] == MOE_TINY["num_hidden_layers"]
    assert bwd[FLASH_FWD] == dense == 2
    _trajectories(jm, tm, ids, labels, 10, 3e-4)
