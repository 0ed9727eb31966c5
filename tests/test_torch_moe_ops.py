"""The MoE remainder against the JAX package on the CPU: the routing ops of
``ops/moe_ops.py`` (``number_count``, ``assign_pos``, ``limit_by_capacity``,
``prune_gate_by_capacity``) exactly, on seeded ids, with dropped (-1) ids
and several workers; and ``MoELayer`` over a list of expert modules
(``_StackedLayers``, always the capacity route): output, aux loss and every
gradient against JAX's layer over the same list (within 2e-5 of max |JAX|:
f32 sums in other orders), the list bit for bit the same layer as
``MLPExperts`` on the same weights, and under ``auto_cast(level="O1")``
the experts' products cast as JAX casts them (the modules' ops are
dispatched nested in ``moe_layer``: bf16 products, the routing f32),
within 1e-2 of max |JAX|."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.nn as jnn
from paddle_tpu.ops import moe_ops as jops
from paddle_tpu.parallel.moe import GShardGate as JGShardGate
from paddle_tpu.parallel.moe import MoELayer as JMoELayer
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models import load_paddle_tpu_state
from paddle_tpu_torch.ops import moe_ops as tops
from paddle_tpu_torch.parallel import GShardGate, MLPExperts, MoELayer

torch.set_num_threads(2)

E, D, H = 4, 32, 48


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_routing_ops_match_jax_exactly(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, E, 40).astype(np.int64)
    _eq(tops.number_count(torch.from_numpy(ids), E),
        jops.number_count(paddle.to_tensor(ids), E))
    dropped = ids.copy()
    dropped[rng.rand(40) < 0.3] = -1
    _eq(tops.number_count(torch.from_numpy(dropped), E),
        jops.number_count(paddle.to_tensor(dropped), E))
    counts = np.bincount(ids, minlength=E)
    cum = np.cumsum(counts)
    pos = tops.assign_pos(torch.from_numpy(ids), torch.from_numpy(cum))
    _eq(pos, jops.assign_pos(paddle.to_tensor(ids), paddle.to_tensor(cum)))
    # the permutation groups tokens by expert, stable within one
    assert sorted(pos.tolist()) == list(range(40))
    assert np.all(np.diff(ids[pos.numpy()]) >= 0)
    cap = rng.randint(2, 12)
    for n_worker in (1, 2):
        ec = rng.randint(0, 15, E * n_worker).astype(np.int64)
        _eq(tops.limit_by_capacity(torch.from_numpy(ec), cap, n_worker),
            jops.limit_by_capacity(paddle.to_tensor(ec), cap, n_worker))
        limit = np.minimum(np.bincount(ids, minlength=E * n_worker), cap)
        _eq(tops.prune_gate_by_capacity(torch.from_numpy(ids),
                                        torch.from_numpy(limit), E,
                                        n_worker),
            jops.prune_gate_by_capacity(paddle.to_tensor(ids),
                                        paddle.to_tensor(limit), E,
                                        n_worker))
    caps = rng.randint(0, 8, E).astype(np.int64)
    _eq(tops.limit_by_capacity(torch.from_numpy(counts), torch.from_numpy(
        caps)), jops.limit_by_capacity(paddle.to_tensor(counts),
                                       paddle.to_tensor(caps)))


def _jax_expert():
    return jnn.Sequential(jnn.Linear(D, H), jnn.GELU(), jnn.Linear(H, D))


def _port_expert():
    return torch.nn.Sequential(torch.nn.Linear(D, H), torch.nn.GELU(),
                               torch.nn.Linear(H, D))


def _stacked_pair(seed, cf=1.0):
    paddle.seed(seed)
    ja = JMoELayer(JGShardGate(D, E, capacity_factor=cf),
                   [_jax_expert() for _ in range(E)])
    tl = MoELayer(GShardGate(D, E, capacity_factor=cf, device="cpu"),
                  [_port_expert() for _ in range(E)])
    load_paddle_tpu_state(tl, {k: np.asarray(v.numpy())
                               for k, v in ja.state_dict().items()})
    return ja, tl


def test_stacked_experts_match_jax():
    """Capacity factor 1.0 drops some pairs; output, aux loss and the
    gradients of x, the gate and every expert parameter."""
    ja, tl = _stacked_pair(5)
    assert not tl.use_grouped()
    assert sorted(n for n, _ in tl.named_parameters()) == sorted(
        n for n, _ in ja.named_parameters())
    rng = np.random.RandomState(6)
    x = rng.randn(2, 20, D).astype(np.float32)
    r = rng.randn(2, 20, D).astype(np.float32)
    jx = paddle.to_tensor(x)
    jx.stop_gradient = False
    jy = ja(jx)
    ((jy * paddle.to_tensor(r)).sum() + ja.aux_loss).backward()
    tx = torch.tensor(x, requires_grad=True)
    ty = tl(tx)
    ((ty * torch.from_numpy(r)).sum() + tl.aux_loss).backward()

    def near(t, j, name):
        j = np.asarray(j.numpy())
        scale = float(np.abs(j).max())
        np.testing.assert_allclose(t, j, atol=2e-5 * scale, rtol=0,
                                   err_msg=name)

    near(ty.detach().numpy(), jy, "out")
    np.testing.assert_allclose(tl.aux_loss.item(), float(ja.aux_loss),
                               rtol=1e-6)
    near(tx.grad.numpy(), jx.grad, "x")
    jp = dict(ja.named_parameters())
    for name, p in tl.named_parameters():
        g = p.grad.numpy()
        if name.endswith("weight") and g.ndim == 2 and "gate" not in name:
            g = g.T
        near(g, jp[name].grad, name)


class _SwigluExpert(torch.nn.Module):
    """One slot of a swiglu ``MLPExperts``, as a module of its own."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        self.w1, self.b1 = torch.nn.Parameter(w1), torch.nn.Parameter(b1)
        self.w2, self.b2 = torch.nn.Parameter(w2), torch.nn.Parameter(b2)

    def forward(self, x):
        g, u = (x @ self.w1 + self.b1).chunk(2, dim=-1)
        return (torch.nn.functional.silu(g) * u) @ self.w2 + self.b2


def test_stacked_list_equals_mlp_experts():
    experts = MLPExperts(E, D, H, activation="swiglu", device="cpu", seed=8)
    gate = GShardGate(D, E, device="cpu", seed=9)
    dense = MoELayer(gate, experts, dispatch="capacity")
    listed = MoELayer(gate, [
        _SwigluExpert(*(getattr(experts, n)[e].detach().clone()
                        for n in ("w1", "b1", "w2", "b2")))
        for e in range(E)])
    x = torch.randn(3, 16, D, generator=torch.Generator().manual_seed(10))
    a, b = dense(x), listed(x)
    assert torch.equal(a, b)
    a.square().sum().backward()
    b.square().sum().backward()
    for e, mod in enumerate(listed.experts.children()):
        assert torch.equal(mod.w1.grad, experts.w1.grad[e])
        assert torch.equal(mod.b2.grad, experts.b2.grad[e])


def test_stacked_experts_under_auto_cast_match_jax():
    ja, tl = _stacked_pair(11, cf=2.0)
    x = np.random.RandomState(12).randn(2, 16, D).astype(np.float32)
    seen = []
    hook = tl.experts.get_submodule("0.0").register_forward_hook(
        lambda m, a, out: seen.append(out.dtype))
    with jamp.auto_cast(level="O1"):
        jy = np.asarray(ja(paddle.to_tensor(x)).numpy())
    with torch.no_grad(), tamp.auto_cast(level="O1"):
        ty = tl(torch.from_numpy(x))
    hook.remove()
    assert seen == [torch.bfloat16]
    assert ty.dtype == torch.float32 and jy.dtype == np.float32
    scale = float(np.abs(jy).max())
    np.testing.assert_allclose(ty.numpy(), jy, atol=1e-2 * scale, rtol=0)
    with torch.no_grad():
        f32 = tl(torch.from_numpy(x))
    assert not torch.equal(f32, ty)
