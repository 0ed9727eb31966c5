"""``paddle_tpu_torch.save`` / ``load`` (``framework/io.py``) on the CPU:
nested containers of tensors round trip bit for bit with their dtypes
(bf16 as its raw 16 bits), parameters come back as ``nn.Parameter`` with
``requires_grad`` the inverse of the saved ``stop_gradient``, an optimizer's
state dict round trips into a fresh optimizer that then steps bit for bit
as the one it came from, and files the JAX package's ``save`` wrote (f32
and bf16 payloads, parameters, nested lists, a model's state dict) load
into the port without ``paddle_tpu`` or ``ml_dtypes``: exact values."""

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.framework import io as jio
from paddle_tpu.models.vit import VIT_PRESETS as JVIT
from paddle_tpu.models.vit import VisionTransformer as JViT
import paddle_tpu_torch as ptt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.models import (VIT_PRESETS, VisionTransformer,
                                     load_paddle_tpu_state)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]


def _nested():
    g = torch.Generator().manual_seed(0)
    w = torch.nn.Parameter(torch.randn(3, 4, generator=g))
    frozen = torch.nn.Parameter(torch.randn(4, generator=g),
                                requires_grad=False)
    return {
        "w": w, "frozen": frozen,
        "bf16": torch.randn(5, 2, generator=g).to(torch.bfloat16),
        "ints": torch.arange(6).reshape(2, 3),
        "deep": [torch.randn(2, generator=g).double(),
                 (torch.tensor(7, dtype=torch.int32), "text", 3.5)],
        "np": np.arange(4, dtype=np.float32), "step": 12,
    }


def _same(a, b):
    assert type(a) is type(b) or (isinstance(a, torch.Tensor)
                                  and isinstance(b, torch.Tensor))
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.detach(), b.detach())
        assert isinstance(b, torch.nn.Parameter) == isinstance(
            a, torch.nn.Parameter)
        assert a.requires_grad == b.requires_grad
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def test_nested_round_trip(tmp_path):
    obj = _nested()
    path = str(tmp_path / "sub" / "obj.pdparams")
    ptt.save(obj, path)
    back = ptt.load(path)
    _same(obj, back)
    assert back["bf16"].dtype == torch.bfloat16
    assert not back["frozen"].requires_grad and back["w"].requires_grad
    # the file names no class of torch: a bf16 payload is uint16 bits
    raw = pickle.load(open(path, "rb"))
    rec = raw["data"]["bf16"]
    assert rec.dtype == "bfloat16" and rec.payload.dtype == np.uint16
    assert raw["magic"] == "paddle_tpu_ckpt_v1"


def test_return_numpy_widens_bf16_exactly(tmp_path):
    obj = _nested()
    ptt.save(obj, str(tmp_path / "o"))
    back = ptt.load(str(tmp_path / "o"), return_numpy=True)
    np.testing.assert_array_equal(back["bf16"],
                                  obj["bf16"].float().numpy())
    assert back["bf16"].dtype == np.float32
    np.testing.assert_array_equal(back["w"], obj["w"].detach().numpy())
    assert back["ints"].dtype == np.int64


def test_optimizer_state_round_trip_resumes_bit_for_bit(tmp_path):
    """AdamW with a scheduler and f32 masters over a bf16 model: 3 steps,
    save, load into a fresh model and optimizer, 3 more steps: every
    parameter and the state bit for bit as 6 unbroken steps."""
    def make():
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 3)).to(torch.bfloat16)
        sched = topt.lr.StepDecay(1e-2, step_size=2, gamma=0.5)
        o = topt.AdamW(learning_rate=sched, parameters=m.parameters(),
                       weight_decay=0.1, multi_precision=True)
        return m, o, sched

    xs = torch.randn(6, 4, 6, generator=torch.Generator().manual_seed(1))

    def step(m, o, sched, x):
        m(x.to(torch.bfloat16)).float().square().mean().backward()
        o.step()
        o.clear_grad()
        sched.step()

    m, o, sched = make()
    for x in xs:
        step(m, o, sched, x)
    m2, o2, sched2 = make()
    for x in xs[:3]:
        step(m2, o2, sched2, x)
    ptt.save(m2.state_dict(), str(tmp_path / "m.pdparams"))
    ptt.save(o2.state_dict(), str(tmp_path / "m.pdopt"))
    m3, o3, sched3 = make()
    m3.load_state_dict(ptt.load(str(tmp_path / "m.pdparams")))
    o3.set_state_dict(ptt.load(str(tmp_path / "m.pdopt")))
    assert o3._step_count == 3 and sched3.last_epoch == sched2.last_epoch
    for x in xs[3:]:
        step(m3, o3, sched3, x)
    for a, b in zip(m.parameters(), m3.parameters()):
        assert torch.equal(a, b)
    sd, sd3 = o.state_dict(), o3.state_dict()
    assert sd.keys() == sd3.keys()
    for k in sd:
        if isinstance(sd[k], torch.Tensor):
            assert torch.equal(sd[k], sd3[k]), k
        else:
            assert sd[k] == sd3[k], k


def test_reads_a_file_the_jax_package_wrote(tmp_path):
    """f32 and bf16 payloads, a trainable and a frozen parameter, a nested
    list and plain values, written by ``paddle_tpu.save``; the port's load
    neither imports ``paddle_tpu`` (its unpickler maps the proxy) nor needs
    ``ml_dtypes``."""
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    a = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal((2, 5)).astype(np.float32)
    w = JParameter(a, name="w")
    f = JParameter(a[0], name="f", trainable=False)
    obj = {"w": w, "f": f,
           "bf16": paddle.to_tensor(jnp.asarray(b).astype(jnp.bfloat16)),
           "nest": [paddle.to_tensor(np.arange(3, dtype=np.int32)),
                    {"k": 2, "s": "x"}],
           "arr": np.arange(5, dtype=np.int64)}
    path = str(tmp_path / "j.pdparams")
    jio.save(obj, path)
    back = tio.load(path)
    assert isinstance(back["w"], torch.nn.Parameter)
    assert back["w"].requires_grad and not back["f"].requires_grad
    np.testing.assert_array_equal(back["w"].detach().numpy(), a)
    assert back["bf16"].dtype == torch.bfloat16
    want = np.asarray(obj["bf16"].numpy()).view(np.uint16)
    np.testing.assert_array_equal(
        back["bf16"].view(torch.int16).numpy().view(np.uint16), want)
    np.testing.assert_array_equal(back["nest"][0].numpy(), [0, 1, 2])
    assert back["nest"][1] == {"k": 2, "s": "x"}
    np.testing.assert_array_equal(back["arr"], np.arange(5))
    numpy_back = tio.load(path, return_numpy=True)
    np.testing.assert_array_equal(numpy_back["bf16"],
                                  back["bf16"].float().numpy())
    # without the JAX package importable, the same file loads
    code = ("import sys; sys.modules['paddle_tpu'] = None; "
            "sys.modules['ml_dtypes'] = None; "
            "from paddle_tpu_torch.framework import io; "
            f"d = io.load({path!r}); "
            "print(d['bf16'].dtype, float(d['w'].sum()))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=str(ROOT)).stdout.split()
    assert out[0] == "torch.bfloat16"
    assert float(out[1]) == pytest.approx(float(a.sum()), rel=1e-6)


def test_jax_model_checkpoint_loads_into_the_port(tmp_path):
    """``paddle.save(vit.state_dict())`` from JAX, ``load`` in the port,
    then ``load_paddle_tpu_state``: the port's vit-tiny gives JAX's
    logits."""
    paddle.seed(5)
    jm = JViT(JVIT["vit-tiny"])
    jio.save(jm.state_dict(), str(tmp_path / "vit.pdparams"))
    sd = tio.load(str(tmp_path / "vit.pdparams"), return_numpy=True)
    tm = VisionTransformer(VIT_PRESETS["vit-tiny"], device="cpu")
    load_paddle_tpu_state(tm, sd)
    x = np.random.RandomState(6).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    want = np.asarray(jm(paddle.to_tensor(x)).numpy())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
