"""The port's distributed checkpoints (``parallel/checkpoint.py``) on the
CPU: a sharded save from ``ShardedTrainStep`` at fsdp 2 (stage 3) loaded
into a tp 2 step in two gloo processes, a directory written by JAX's
``save_state_dict`` from arrays sharded over its 8 virtual devices loaded
by the port in one process, the port's directory (f32 and bf16) loaded by
JAX, and the refusal of JAX's bf16 chunks without ``ml_dtypes``. Every
saved and loaded value bit for bit; the step taken after the load against
one step of the one-process ``TrainStep`` from the same weights: the loss
within 1e-6 relative, the parameters within 1e-4.
"""

import pickle

import numpy as np
import pytest
import torch

from test_torch_parallel import run_ranks

LR = 1e-2


def _save_fsdp_load_tp(rank, world, state, ids, path):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.optimizer import AdamW
    from test_torch_parallel import _port_model

    model = _port_model(state)
    step = P.ShardedTrainStep(model, None, AdamW(
        learning_rate=LR, parameters=model.parameters()),
        P.HybridMesh(fsdp=2), stage=3)
    step(ids, ids)
    step(ids, ids)
    sd = step.sharded_state_dict()
    local = {n: tuple(s.tensor.shape) for n, s in sd.items()}
    P.save_state_dict(sd, path)
    step.gather_params_to_model()
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}

    other = _port_model(state)          # the weights before training
    step2 = P.ShardedTrainStep(other, None, AdamW(
        learning_rate=LR, parameters=other.parameters()),
        P.HybridMesh(tp=2), stage=0)
    P.load_state_dict(step2.sharded_state_dict(), path)
    loss = step2(ids, ids).item()       # trains on from the loaded shards
    step2.gather_params_to_model()
    return {"saved": saved, "local": local, "loss": loss,
            "loaded_then_trained": {n: p.detach().clone()
                                    for n, p in other.named_parameters()}}


def test_save_at_fsdp2_load_at_tp2(tmp_path):
    from test_torch_parallel import TINY, _port_model

    # the port's own seeded weights: the test holds the port to itself
    state = None
    ids = np.random.RandomState(1).randint(0, TINY["vocab_size"], (8, 16))
    path = str(tmp_path / "ckpt")
    res = run_ranks(_save_fsdp_load_tp, 2, tmp_path / "run", state,
                    torch.from_numpy(ids), path)
    for n, p in res[0]["saved"].items():
        assert torch.equal(p, res[1]["saved"][n])
    # a stage-3 shard is half a weight
    assert res[0]["local"]["lm_head.weight"] == (128, 32)
    # one process reads the whole directory back as written
    from paddle_tpu_torch.parallel import load_state_dict

    full = {n: torch.zeros_like(p) for n, p in res[0]["saved"].items()}
    load_state_dict(full, path)
    for n, p in full.items():
        assert torch.equal(p, res[0]["saved"][n]), n
    # the tp run continued from the loaded weights: one more step of the
    # one-process TrainStep from them gives the same parameters
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    m = _port_model(state)
    with torch.no_grad():
        for n, p in m.named_parameters():
            p.copy_(full[n])
    loss = TrainStep(m, None, AdamW(learning_rate=LR,
                                    parameters=m.parameters()))(
        torch.from_numpy(ids), torch.from_numpy(ids)).item()
    np.testing.assert_allclose(res[0]["loss"], loss, rtol=1e-6)
    # a fresh Adam moves a parameter by lr * g / (|g| + eps): where g is
    # of the order of eps, the rounding of g (sums in another order under
    # tp) moves it by up to 1e-5 here
    for n, p in m.named_parameters():
        np.testing.assert_allclose(res[0]["loaded_then_trained"][n].numpy(),
                                   p.detach().numpy(), atol=1e-4, err_msg=n)


def test_directory_written_by_jax_loads_in_the_port(tmp_path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP

    from paddle_tpu.parallel import HybridMesh
    from paddle_tpu.parallel.checkpoint import save_state_dict as jax_save
    from paddle_tpu_torch.parallel import load_state_dict

    rng = np.random.RandomState(5)
    arrays = {"a.weight": rng.standard_normal((16, 6)).astype(np.float32),
              "b.weight": rng.standard_normal((4, 24)).astype(np.float32),
              "c.bias": rng.standard_normal((5,)).astype(np.float32),
              "step": np.arange(3, dtype=np.int32)}
    mesh = HybridMesh(fsdp=4, tp=2).mesh
    specs = {"a.weight": JP("fsdp", "tp"), "b.weight": JP(None, "fsdp"),
             "c.bias": JP(), "step": JP()}
    jax_save({"model": {k: jax.device_put(jnp.asarray(v),
                                          NamedSharding(mesh, specs[k]))
                        for k, v in arrays.items()}}, str(tmp_path))
    target = {"model": {k: torch.zeros(v.shape, dtype=torch.from_numpy(
        v).dtype) for k, v in arrays.items()}}
    out = load_state_dict(target, str(tmp_path))
    for k, v in arrays.items():
        np.testing.assert_array_equal(out["model"][k].numpy(), v)


def test_directory_written_by_the_port_loads_in_jax(tmp_path):
    import jax.numpy as jnp

    from paddle_tpu.core.tensor import Tensor as JTensor
    from paddle_tpu.parallel.checkpoint import load_state_dict as jax_load
    from paddle_tpu_torch.parallel import save_state_dict

    rng = np.random.RandomState(6)
    w = torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32))
    h = w.to(torch.bfloat16)
    save_state_dict({"w": w, "h": h}, str(tmp_path))
    got = jax_load({"w": JTensor(jnp.zeros((8, 3), jnp.float32)),
                    "h": JTensor(jnp.zeros((8, 3), jnp.bfloat16))},
                   str(tmp_path))
    np.testing.assert_array_equal(np.asarray(got["w"]._data), w.numpy())
    assert got["h"]._data.dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got["h"]._data, np.float32),
                                  h.float().numpy())


def test_jax_bf16_chunks_without_ml_dtypes_are_refused(tmp_path,
                                                       monkeypatch):
    import jax.numpy as jnp

    from paddle_tpu.parallel.checkpoint import save_state_dict as jax_save
    from paddle_tpu_torch.parallel import checkpoint as ck

    h = jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3),
                    jnp.bfloat16)
    jax_save({"h": h}, str(tmp_path))
    # with ml_dtypes the chunk reads back as bf16
    got = ck.load_state_dict({"h": torch.zeros(2, 3, dtype=torch.bfloat16)},
                             str(tmp_path))
    assert torch.equal(got["h"].float(), torch.arange(6.0).reshape(2, 3))

    def no_ml_dtypes(f):
        raise ModuleNotFoundError("No module named 'ml_dtypes'")
    monkeypatch.setattr(pickle, "load", no_ml_dtypes)
    with pytest.raises(RuntimeError, match="ml_dtypes"):
        ck.load_state_dict({"h": torch.zeros(2, 3)}, str(tmp_path))
