"""The port's host offload (``parallel/offload.py``) on the CPU, held against
JAX's ``tests/test_offload.py:34-63``: ``OffloadedTrainStep``'s losses equal
to the port's stage-3 ``ShardedTrainStep`` and to JAX's
``OffloadedTrainStep`` (on its 8 virtual devices, dp 2 x fsdp 2 x tp 2,
from the same weights), the optimizer state on the host between steps and
written back into the same buffers, and the ``AsyncLoader`` round trip.

The port's steps run in this process on a one-rank gloo group (started by
a module fixture and destroyed after it): the offload is per rank, and
the multi-rank sharded step is ``test_torch_parallel.py``'s. Tolerances:
the port's two steps exactly equal (the same updates, the state only
moved); against JAX at its own offload gate, rtol 2e-4.
"""

import numpy as np
import pytest
import torch

CFG = dict(vocab_size=256, hidden_size=128, intermediate_size=344,
           num_hidden_layers=2, num_attention_heads=8, num_key_value_heads=4,
           max_position_embeddings=128, dtype="float32")
STEPS, LR, CLIP = 4, 1e-3, 1.0


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import HybridMesh, env, init_parallel_env

    store = tmp_path_factory.mktemp("offload") / "store"
    init_parallel_env(init_method=f"file://{store}", world_size=1, rank=0,
                      device="cpu", timeout=60)
    try:
        yield HybridMesh()
    finally:
        dist.destroy_process_group()
        env.set_mesh(None)
        env._device = None


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX model's weights, a batch, and JAX's OffloadedTrainStep
    losses."""
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.parallel import HybridMesh, OffloadedTrainStep

    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig(**CFG))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(3).randint(0, 256, (4, 32))
    step = OffloadedTrainStep(jm, None, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters()),
        HybridMesh(dp=2, fsdp=2, tp=2).mesh, clip_norm=CLIP)
    jids = paddle.to_tensor(ids)
    return state, ids, [float(step(jids, jids)) for _ in range(STEPS)]


def _run(cls, mesh, state, ids, **kw):
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)
    from paddle_tpu_torch.optimizer import AdamW

    m = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    load_paddle_tpu_state(m, state)
    step = cls(m, None, AdamW(learning_rate=LR, parameters=m.parameters()),
               mesh, clip_norm=CLIP, **kw)
    ids = torch.from_numpy(ids)
    return [step(ids, ids).item() for _ in range(STEPS)], step, m


def test_losses_match_sharded_step_and_jax(one_rank, jax_reference):
    from paddle_tpu_torch.parallel import (OffloadedTrainStep,
                                           ShardedTrainStep, ShardingStage)

    state, ids, jax_losses = jax_reference
    base, _, bm = _run(ShardedTrainStep, one_rank, state, ids,
                       stage=ShardingStage.P_G_OS)
    off, _, om = _run(OffloadedTrainStep, one_rank, state, ids)
    assert off == base
    for (n, p), q in zip(om.named_parameters(), bm.parameters()):
        assert torch.equal(p, q), n
    np.testing.assert_allclose(off, jax_losses, rtol=2e-4)
    assert off[-1] < off[0]


def test_state_lives_on_host_between_steps(one_rank, jax_reference):
    """Every state tensor is a host tensor, the same buffers every step
    (written back in place), and changed by the steps; each step prefetches
    and writes back every parameter's state once."""
    from paddle_tpu_torch.parallel import OffloadedTrainStep

    state, ids = jax_reference[:2]
    _, step, model = _run(OffloadedTrainStep, one_rank, state, ids)
    host = step._host_state
    assert len(host) == len(list(model.parameters()))
    leaves = [t for st in host for t in st.values()]
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    assert all(float(st["moment2"].abs().max()) > 0 for st in host)
    before = [t.clone() for t in leaves]
    ptrs = [t.data_ptr() for t in leaves]
    calls = {"prefetch": 0, "offload": 0}
    for name in calls:
        inner = getattr(step.loader, name)

        def counted(*a, _inner=inner, _name=name, **k):
            calls[_name] += 1
            return _inner(*a, **k)
        setattr(step.loader, name, counted)
    batch = torch.from_numpy(ids)
    step(batch, batch)
    assert [t.data_ptr() for t in leaves] == ptrs
    assert any(not torch.equal(a, b) for a, b in zip(leaves, before))
    assert calls == {"prefetch": len(host), "offload": len(host)}


def test_async_loader_roundtrip():
    from paddle_tpu_torch.parallel import AsyncLoader

    loader = AsyncLoader("cpu")
    tree = {"a": torch.arange(8.0), "b": [torch.ones(4, 4), 3]}
    host = loader.wait(loader.offload(tree))
    assert host["a"].device.type == "cpu" and host["b"][1] == 3
    assert host["a"] is not tree["a"]
    torch.testing.assert_close(host["a"], tree["a"], rtol=0, atol=0)
    back = loader.wait(loader.prefetch(host))
    np.testing.assert_array_equal(back["a"].numpy(), np.arange(8.0))
    out = {"a": torch.zeros(8), "b": [torch.zeros(4, 4), 3]}
    filled = loader.offload(tree, out=out)
    assert filled is out and torch.equal(out["b"][0], torch.ones(4, 4))
    assert loader.transfer_ms() == {"h2d": 0.0, "d2h": 0.0}
