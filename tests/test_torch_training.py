"""The port's training path against the JAX package on the CPU, in f32, on
the tiny Llama of ``test_torch_model.py`` with the JAX model's weights
loaded into the port through ``load_paddle_tpu_state``.

Tolerances: the per-step loss within 1e-4 relative, the parameters after
the run within 1e-5 absolute, and each Adam moment within 2e-4 relative
plus 1e-4 of that tensor's largest moment: the two frameworks sum in
different orders, so f32 rounding differs from the first step on and
Adam's normalised steps carry it forward, and a moment of a gradient that
nearly cancels has no relative precision of its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.optimizer as jopt
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.optimizer import Adam, AdamW, FusedAdamW

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
MOMENT_RTOL, MOMENT_ATOL_OF_MAX = 2e-4, 1e-4


def _is_linear(name):
    return name.endswith(("_proj.weight", "lm_head.weight"))


def as_jax_layout(name, t):
    """A port tensor in the JAX layout (linear weights ``[in, out]``)."""
    a = t.detach().float().numpy()
    return a.T if _is_linear(name) else a


def assert_moments_close(ours, ref, what):
    np.testing.assert_allclose(
        ours, ref, rtol=MOMENT_RTOL,
        atol=MOMENT_ATOL_OF_MAX * float(np.abs(ref).max()), err_msg=what)


def make_pair(seed, **over):
    """A JAX tiny Llama and the port's copy of it (CPU)."""
    paddle.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY, **over))
    tm = LlamaForCausalLM(LlamaConfig(**TINY, **over), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy()) for k, v in
                               jm.state_dict().items()})
    return jm, tm


def batch(seed):
    """Token ids [2, 24] and labels = ids with a few ignored positions."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (2, 24))
    labels = ids.copy()
    labels[0, 5] = labels[1, 17] = labels[1, 18] = -100
    return ids, labels


@pytest.mark.parametrize("fused_loss", [True, False])
def test_train_step_matches_jax(fused_loss):
    """20 TrainStep steps with AdamW (wd 0.1) and clip_norm 1.0: the loss
    at every step, then every parameter and both moments."""
    jm, tm = make_pair(21, fused_loss=fused_loss)
    ids, labels = batch(22)
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
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(jparams)
    for (name, p), state in zip(tm.named_parameters(), tstep._state):
        np.testing.assert_allclose(as_jax_layout(name, p), jparams[name],
                                   atol=PARAM_ATOL, err_msg=name)
        for key in ("moment1", "moment2"):
            assert_moments_close(as_jax_layout(name, state[key]),
                                 np.asarray(jstep._opt_state[name][key]),
                                 f"{name} {key}")


def _trajectories_match(jm, tm, jargs, targs, steps):
    """``steps`` TrainStep steps of both models (AdamW lr 1e-3, wd 0.1, clip
    1.0): the loss at every step, then every parameter."""
    jstep = JaxTrainStep(jm, None, jopt.AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=jm.parameters()),
        clip_norm=1.0)
    tstep = TrainStep(tm, None, AdamW(
        learning_rate=1e-3, weight_decay=0.1, parameters=tm.parameters()),
        clip_norm=1.0)
    jl = [float(jstep(*jargs)) for _ in range(steps)]
    tl = [float(tstep(*targs)) for _ in range(steps)]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0] - 0.1
    jparams = {n: np.asarray(v) for n, v in jstep._params.items()}
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(jparams)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(as_jax_layout(name, p), jparams[name],
                                   atol=PARAM_ATOL, err_msg=name)


def test_tied_train_step_matches_jax():
    """20 TrainStep steps of the tied tiny Llama (the embedding matrix is
    the head, and gets the gradients of both uses) against JAX."""
    jm, tm = make_pair(21, tie_word_embeddings=True, fused_loss=True)
    assert tm.lm_head is None
    ids, labels = batch(22)
    _trajectories_match(
        jm, tm, (paddle.to_tensor(ids), paddle.to_tensor(labels)),
        (torch.from_numpy(ids), torch.from_numpy(labels)), 20)


def test_packed_varlen_train_step_matches_jax():
    """10 TrainStep steps on packed sequences: segment ids (3 segments a
    row), positions restarting per segment and the label of each segment's
    first token ignored, through ``loss_fn`` in both frameworks."""
    jm, tm = make_pair(23, fused_loss=True)
    ids, labels = batch(24)
    seg = np.zeros_like(ids)
    seg[:, 7:] += 1
    seg[:, 16:] += 1
    pos = np.arange(ids.shape[1]) - np.array([0, 7, 16])[seg]
    labels[:, [7, 16]] = -100

    def jloss(out, *_):
        return out[0]

    class Packed(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, ids_, labels_, seg_, pos_):
            return self.model(ids_, labels=labels_, segment_ids=seg_,
                              position_ids=pos_)

    class JPacked(paddle.nn.Layer):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, ids_, labels_, seg_, pos_):
            return self.model(ids_, labels=labels_, segment_ids=seg_,
                              position_ids=pos_)

    _trajectories_match(
        JPacked(jm), Packed(tm),
        tuple(paddle.to_tensor(a) for a in (ids, labels, seg, pos)),
        tuple(torch.from_numpy(a) for a in (ids, labels, seg, pos)), 10)


def _fused_views(opt, named, flat):
    """{name: the parameter's slice of a FusedAdamW flat buffer}, in the
    parameter's own shape."""
    by_id = {id(p): n for n, p in named}
    return {by_id[id(p)]: np.asarray(flat)[off:off + size].reshape(
        tuple(p.shape)) for p, off, size in opt._views}


def test_fused_adamw_eager_matches_jax():
    """Three eager steps (``loss.backward(); opt.step(); opt.clear_grad()``)
    of the port's FusedAdamW against the JAX FusedAdamW, which runs
    ``fused_adamw_flat`` in Pallas interpret mode here. Before the third
    step the final norm is frozen in both: the participating set changes,
    the flat buffers are rebuilt and every other parameter's moments must
    carry over."""
    jm, tm = make_pair(23)
    ids, labels = batch(24)
    jo = jopt.FusedAdamW(learning_rate=1e-3, weight_decay=0.1,
                         parameters=jm.parameters())
    to = FusedAdamW(learning_rate=1e-3, weight_decay=0.1,
                    parameters=tm.parameters())
    frozen = "model.norm.weight"
    for step in range(3):
        if step == 2:
            dict(jm.named_parameters())[frozen].stop_gradient = True
            dict(tm.named_parameters())[frozen].requires_grad_(False)
        jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
        jloss.backward()
        jo.step()
        jo.clear_grad()
        tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
        tloss.backward()
        to.step()
        to.clear_grad()
        np.testing.assert_allclose(tloss.item(), float(jloss),
                                   rtol=LOSS_RTOL)
    assert to._step_count == jo._step_count == 3
    jnamed, tnamed = list(jm.named_parameters()), list(tm.named_parameters())
    assert len(to._views) == len(jo._views) == len(tnamed) - 1
    for flat in ("_flat", "_m", "_v"):
        jv = _fused_views(jo, jnamed, getattr(jo, flat))
        tv = _fused_views(to, tnamed, getattr(to, flat).numpy())
        assert sorted(jv) == sorted(tv) and frozen not in tv
        for name in tv:
            ours = tv[name].T if _is_linear(name) else tv[name]
            if flat == "_flat":
                np.testing.assert_allclose(ours, jv[name], atol=PARAM_ATOL,
                                           err_msg=f"{name} {flat}")
            else:
                assert_moments_close(ours, jv[name], f"{name} {flat}")
    for (n, p) in tnamed:
        if n != frozen:
            np.testing.assert_allclose(as_jax_layout(n, p),
                                       np.asarray(dict(jnamed)[n].numpy()),
                                       atol=PARAM_ATOL, err_msg=n)


def test_fused_adamw_carries_moments_across_a_freeze():
    """The port alone, exactly: after freezing the bias, the weight's first
    moment is b1 m + (1 - b1) g of the carried m."""
    torch.manual_seed(0)
    lin = torch.nn.Linear(4, 4)
    opt = FusedAdamW(learning_rate=1e-2, parameters=lin.parameters())
    x = torch.randn(2, 4)
    (lin(x) ** 2).mean().backward()
    opt.step()
    opt.clear_grad()
    m_before = opt._m[:16].clone()
    lin.bias.requires_grad_(False)
    (lin(x) ** 2).mean().backward()
    g = lin.weight.grad.reshape(-1).clone()
    opt.step()
    opt.clear_grad()
    assert opt._m.numel() == 16
    np.testing.assert_allclose(opt._m.numpy(),
                               (0.9 * m_before + 0.1 * g).numpy(),
                               rtol=1e-6, atol=1e-9)


def test_train_step_rejects_fused_adamw():
    """As in the JAX package, TrainStep cannot take FusedAdamW: it has no
    per-parameter update."""
    _, tm = make_pair(25)
    step = TrainStep(tm, None, FusedAdamW(parameters=tm.parameters()))
    ids, labels = batch(26)
    with pytest.raises(NotImplementedError):
        step(torch.from_numpy(ids), torch.from_numpy(labels))


def test_optimizer_options_not_ported_raise():
    """The options ROADMAP A5 ported (a clip object, master weights, an
    LRScheduler) build and step; a learning rate that is neither a number
    nor a scheduler raises."""
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import StepDecay

    _, tm = make_pair(27)
    for kw in (dict(grad_clip=ClipGradByGlobalNorm(1.0)),
               dict(multi_precision=True),
               dict(learning_rate=StepDecay(1e-3, 2))):
        opt = AdamW(parameters=tm.parameters(), **kw)
        ids = torch.from_numpy(batch(27)[0])
        tm(ids, labels=ids)[0].backward()
        opt.step()
        opt.clear_grad()
        assert opt._step_count == 1
    with pytest.raises(TypeError, match="LRScheduler"):
        AdamW(parameters=tm.parameters(), learning_rate=lambda: 1e-3)
    # recompute is ported (ROADMAP A2): the model builds and trains
    model = LlamaForCausalLM(LlamaConfig(**TINY, recompute=True),
                             device="cpu")
    ids = torch.from_numpy(batch(27)[0])
    loss, _ = model(ids, labels=ids)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


@pytest.mark.parametrize("cls,kw", [
    ("Adam", dict(weight_decay=0.01)),
    ("Adam", dict(amsgrad=True)),
    ("AdamW", dict(weight_decay=0.1, moment_dtype="bfloat16")),
], ids=["adam_l2", "adam_amsgrad", "adamw_bf16_moments"])
def test_adam_update_matches_jax(cls, kw):
    """Three functional updates (``apply_gradients`` against JAX's
    ``apply_gradients_tree``) on f32 parameters: Adam's l2 term, amsgrad,
    and AdamW with bf16 moment storage (compared to one bf16 ulp)."""
    rng = np.random.RandomState(28)
    shapes = {"w": (5, 7), "b": (11,)}
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in shapes.items()}
    tparams = [torch.from_numpy(params[n].copy()) for n in shapes]
    jo = getattr(jopt, cls)(learning_rate=2e-3, parameters=[], **kw)
    to = {"Adam": Adam, "AdamW": AdamW}[cls](
        learning_rate=2e-3, parameters=tparams, **kw)
    jparams = {n: jnp.asarray(a) for n, a in params.items()}
    jstate = jo.init_state_tree(jparams)
    tstate = to.init_state(tparams)
    for step in (1, 2, 3):
        grads = {n: rng.standard_normal(s).astype(np.float32)
                 for n, s in shapes.items()}
        jparams, jstate = jo.apply_gradients_tree(
            jparams, {n: jnp.asarray(g) for n, g in grads.items()}, jstate,
            lr=2e-3, step=step)
        tparams, tstate = to.apply_gradients(
            tparams, [torch.from_numpy(grads[n]) for n in shapes], tstate,
            2e-3, step)
    bf16 = kw.get("moment_dtype") == "bfloat16"
    for i, n in enumerate(shapes):
        np.testing.assert_allclose(tparams[i].numpy(), np.asarray(jparams[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
        for key, ref in jstate[n].items():
            ours = tstate[i][key].float().numpy()
            np.testing.assert_allclose(
                ours, np.asarray(ref, np.float32), rtol=2 ** -7 if bf16
                else 1e-6, atol=1e-9, err_msg=f"{n} {key}")


def test_eager_adamw_matches_fused_adamw():
    """The eager surface of the per-parameter AdamW (``step()`` reading
    ``.grad``) against FusedAdamW on the same model, as the JAX package's
    test does for its two optimizers: the same update, f32 sums in
    another order (1e-5)."""
    torch.manual_seed(1)
    m1 = torch.nn.Linear(16, 16)
    m2 = torch.nn.Linear(16, 16)
    m2.load_state_dict(m1.state_dict())
    o1 = AdamW(learning_rate=1e-2, weight_decay=0.1,
               parameters=m1.parameters())
    o2 = FusedAdamW(learning_rate=1e-2, weight_decay=0.1,
                    parameters=m2.parameters())
    x = torch.randn(8, 16)
    for _ in range(3):
        for m, o in ((m1, o1), (m2, o2)):
            (m(x) ** 2).mean().backward()
            o.step()
            o.clear_grad()
    assert o1._step_count == o2._step_count == 3
    assert all(p.grad is None for p in m1.parameters())
    for pa, pb in zip(m1.parameters(), m2.parameters()):
        np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)
