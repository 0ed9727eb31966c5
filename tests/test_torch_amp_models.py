"""``auto_cast`` on the Mamba, Mamba-2, RWKV and MoE-Llama models: the port
against the JAX package on the CPU.

The JAX package casts at its op dispatcher, so under ``auto_cast`` only the
inputs of dispatched ops are cast, by the op's name; what runs inside an
op's body is raw array code, never cast. In these four models the bodies
are ``mamba_conv_proj`` and ``selective_scan`` (Mamba), ``mamba2_conv_proj``,
``ssd_chunked`` and ``mamba2_gate_out`` (Mamba-2), ``token_shift``,
``rwkv_log_decay`` and ``rwkv_linear_attention`` (RWKV) and ``moe_layer``
(the routing and the experts of the MoE layer). The port must cast their
inputs by those names and run their bodies with its autocast mode off.

``test_regions_match_jax``: each of those ops as the JAX model calls it in
one forward under ``auto_cast(level)`` (an f32 model, so under O2 every
input is cast), its inputs captured before the cast, given to the port's
counterpart under the same ``auto_cast``: the output dtype must be JAX's,
the values within 2e-5 of max |JAX| under O1 (the bodies run in f32 there;
a bf16 output, such as the WKV's of bf16 r, k, v, within one bf16 unit in
the last place of each value) and within 3e-2 of max |JAX| under O2 (the
bodies run in bf16, which keeps 8 bits; the two packages round their bf16
sums in another order, and the selective scan of JAX runs in the promoted
bf16 where the port's runs in f32). Under O1 the
f32 Mamba is refused by JAX (its conv gets the bf16 output of ``in_proj``
against f32 weights); the port's must refuse the same inputs.

``test_steps_match_jax``: three AdamW steps of each model under
``auto_cast`` (O2 through ``decorate``: bf16 parameters, f32 masters) from
the JAX weights: each loss within 1e-2 relative of JAX's (bf16 products
and sums round differently in the two packages, and Adam's normalised steps
carry that into the weights from the first step on; the Llama loop holds
5e-3 over 10 steps, these models' bf16 scans and routing a little more).
The f32 Mamba under O1 is refused by both.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.models.mamba import MambaConfig as JMambaConfig
from paddle_tpu.models.mamba import MambaForCausalLM as JMamba
from paddle_tpu.models.mamba2 import Mamba2Config as JMamba2Config
from paddle_tpu.models.mamba2 import Mamba2ForCausalLM as JMamba2
from paddle_tpu.models.moe_llm import MoELlamaConfig as JMoEConfig
from paddle_tpu.models.moe_llm import MoELlamaForCausalLM as JMoE
from paddle_tpu.models.rwkv import RwkvConfig as JRwkvConfig
from paddle_tpu.models.rwkv import RwkvForCausalLM as JRwkv
from paddle_tpu.ops import registry
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import (Mamba2Config, Mamba2ForCausalLM,
                                     MambaConfig, MambaForCausalLM,
                                     MoELlamaConfig, MoELlamaForCausalLM,
                                     RwkvConfig, RwkvForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.models import mamba as tmamba
from paddle_tpu_torch.models import mamba2 as tmamba2
from paddle_tpu_torch.ops.fused import rwkv as trwkv
from paddle_tpu_torch.ops.fused import ssd as tssd

torch.set_num_threads(2)

FAMILIES = {
    "mamba": (JMambaConfig, JMamba, MambaConfig, MambaForCausalLM,
              dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                   state_size=16, scan_chunk=16)),
    "mamba2": (JMamba2Config, JMamba2, Mamba2Config, Mamba2ForCausalLM,
               dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    state_size=64, head_dim=64, ssd_chunk=16)),
    "rwkv": (JRwkvConfig, JRwkv, RwkvConfig, RwkvForCausalLM,
             dict(vocab_size=256, hidden_size=128, num_hidden_layers=2,
                  head_dim=64, wkv_chunk=16, wkv_subchunk=8)),
    "moe": (JMoEConfig, JMoE, MoELlamaConfig, MoELlamaForCausalLM,
            dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4,
                 num_key_value_heads=2, max_position_embeddings=64,
                 moe_num_experts=4, moe_topk=2, moe_every=2,
                 fused_loss=False)),
}
REGIONS = {
    "mamba": ("mamba_conv_proj", "selective_scan"),
    "mamba2": ("mamba2_conv_proj", "ssd_chunked", "mamba2_gate_out"),
    "rwkv": ("token_shift", "rwkv_log_decay", "rwkv_linear_attention"),
    "moe": ("moe_layer",),
}
CASES = [(f, lv) for f in FAMILIES for lv in ("O1", "O2")]
REGION_TOL = {"O1": 2e-5, "O2": 3e-2}
STEPS = 3
LOSS_RTOL = 1e-2


def _pair(family, seed=7):
    jcfg, jcls, tcfg, tcls, tiny = FAMILIES[family]
    paddle.seed(seed)
    jm = jcls(jcfg(**tiny, dtype="float32"))
    tm = tcls(tcfg(**tiny, dtype="float32"), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return jm, tm


def _ids(family, seed=3):
    vocab = FAMILIES[family][4]["vocab_size"]
    return np.random.RandomState(seed).randint(0, vocab, (2, 24))


def _np_tree(x):
    if isinstance(x, JTensor):
        return np.asarray(x.numpy())
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np_tree(v) for v in x)
    return x


def _torch_tree(x):
    """numpy (bf16 through ml_dtypes) -> torch, exactly."""
    if isinstance(x, np.ndarray):
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, dict):
        return {k: _torch_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_torch_tree(v) for v in x)
    return x


def _capture_jax(jm, family, level, ids):
    """Run the JAX model's forward under ``auto_cast(level)``; return the
    region calls ``[(name, args, kwargs, outs or exception)]`` with the
    inputs as they reached the dispatcher (before its cast) in numpy."""
    names = set(REGIONS[family])
    calls = []
    orig = registry.dispatch

    def recording(opdef, args, kwargs):
        if opdef.name not in names:
            return orig(opdef, args, kwargs)
        rec = [opdef.name, _np_tree(tuple(args)), _np_tree(dict(kwargs)),
               None]
        calls.append(rec)
        try:
            out = orig(opdef, args, kwargs)
        except TypeError as e:
            rec[3] = e
            raise
        rec[3] = _np_tree(out if isinstance(out, (tuple, list))
                          else (out,))
        return out

    registry.dispatch = recording
    try:
        with jamp.auto_cast(level=level):
            jm(paddle.to_tensor(ids))
    except TypeError:
        pass
    finally:
        registry.dispatch = orig
    return calls


def _port_region(tm, name, args, kwargs):
    """The port's counterpart of JAX op ``name`` called on JAX's inputs
    (linear weights transposed from JAX's ``[in, out]``)."""
    cfg = tm.config
    if name == "mamba_conv_proj":
        xs, cw, cb, xpw, dtw, dtb, alog = args
        return tmamba.conv_proj(xs, cw, cb, xpw.t(), dtw.t(), dtb, alog, cfg)
    if name == "selective_scan":
        return tmamba.selective_scan(*args, **kwargs)
    if name == "mamba2_conv_proj":
        x, inw, cw, cb, dtb, alog = args
        return tmamba2.conv_proj(x, inw.t(), cw, cb, dtb, alog, cfg)
    if name == "ssd_chunked":
        return tssd.ssd_chunked(*args, **kwargs)
    if name == "mamba2_gate_out":
        y, z, nw, ow = args
        return tmamba2.gate_out(y, z, nw, ow.t(), cfg)
    if name in ("token_shift", "rwkv_log_decay", "rwkv_linear_attention"):
        return getattr(trwkv, name)(*args, **kwargs)
    if name == "moe_layer":
        x, gate_w, eparams = args
        layer = next(m for m in tm.modules()
                     if type(m).__name__ == "MoELayer")
        return layer.route_and_combine(x, gate_w, eparams)
    raise KeyError(name)


@pytest.mark.parametrize("family,level", CASES)
def test_regions_match_jax(family, level):
    jm, tm = _pair(family)
    calls = _capture_jax(jm, family, level, _ids(family))
    assert {c[0] for c in calls} >= ({"mamba_conv_proj"}
                                     if (family, level) == ("mamba", "O1")
                                     else set(REGIONS[family]))
    faults = []
    for name, args, kwargs, want in calls:
        targs, tkw = _torch_tree(args), _torch_tree(kwargs)
        if isinstance(want, Exception):
            with pytest.raises(RuntimeError, match="weight type"):
                with torch.no_grad(), tamp.auto_cast(level=level):
                    _port_region(tm, name, targs, tkw)
            continue
        with torch.no_grad(), tamp.auto_cast(level=level):
            got = _port_region(tm, name, targs, tkw)
        got = got if isinstance(got, (tuple, list)) else (got,)
        for i, (g, w) in enumerate(zip(got, want)):
            w_dt = torch.bfloat16 if w.dtype.name == "bfloat16" else \
                torch.from_numpy(np.zeros(1, w.dtype)).dtype
            if g.dtype != w_dt:
                faults.append(f"{name}[{i}]: dtype {g.dtype}, JAX {w_dt}")
                continue
            wf, gf = w.astype(np.float32), g.float().numpy()
            if level == "O1" and w_dt == torch.bfloat16:
                # an f32 body rounded once to bf16: one unit in the last place
                big = np.maximum(np.abs(wf), np.abs(gf))
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
                n_bad = int((np.abs(gf - wf) > ulp).sum())
                if n_bad:
                    faults.append(f"{name}[{i}]: {n_bad} values off by more "
                                  f"than one bf16 unit")
                continue
            err = float(np.abs(gf - wf).max())
            scale = max(float(np.abs(wf).max()), 1e-30)
            if err > REGION_TOL[level] * scale:
                faults.append(f"{name}[{i}]: max err {err / scale:.2e} of "
                              f"max |JAX|")
    assert not faults, faults


def _jax_steps(jm, level, ids):
    opt = jopt.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    if level == "O2":
        jm, opt = jamp.decorate(jm, opt, level="O2")
    losses = []
    for _ in range(STEPS):
        with jamp.auto_cast(level=level):
            loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def _port_steps(tm, level, ids):
    opt = topt.AdamW(learning_rate=1e-3, parameters=tm.parameters())
    if level == "O2":
        tamp.decorate(tm, opt, level="O2")
    losses = []
    for _ in range(STEPS):
        with tamp.auto_cast(level=level):
            loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("family,level", CASES)
def test_steps_match_jax(family, level):
    jm, tm = _pair(family, seed=11)
    ids = _ids(family, seed=12)
    if (family, level) == ("mamba", "O1"):
        with pytest.raises(TypeError):
            _jax_steps(jm, level, ids)
        with pytest.raises(RuntimeError, match="weight type"):
            _port_steps(tm, level, ids)
        return
    jl = _jax_steps(jm, level, ids)
    tl = _port_steps(tm, level, ids)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert np.all(np.isfinite(tl)) and tl[-1] < tl[0]
