"""``paddle_tpu_torch.amp.debugging`` against ``paddle_tpu.amp.debugging``
on the CPU, on vit-tiny with the same weights and images.

Operator statistics of one eval forward, without and under
``auto_cast(level="O2")``: the rows of every op both packages name
(``add``, ``conv2d``, ``flash_attention``, ``gelu``, ``getitem``,
``layer_norm``, ``linear``, ``reshape``) equal JAX's (calls, NaN, Inf, output
dtypes). The names that differ are listed: JAX also dispatches ``concat``,
``expand`` and ``transpose``, which the port runs as torch calls outside
``amp.TORCH_OPS``. The tensor checker on an injected inf: abort mode raises
``FloatingPointError`` naming the op JAX names; ``CHECK_NAN_INF``
continues and logs to ``output_dir``; the op lists choose the same op as
JAX's (JAX's skip list also names the ops only it sees) and the
``debug_step`` window, which counts each package's own ops, the same op
at JAX's count less the three. ``check_numerics`` counts as JAX's;
``compare_accuracy`` reports the same rows; disabling leaves no mode on
torch's stack."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as jamp
from paddle_tpu.amp import debugging as jd
from paddle_tpu.models.vit import VIT_PRESETS as JVIT
from paddle_tpu.models.vit import VisionTransformer as JViT
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.amp import debugging as td
from paddle_tpu_torch.models import (VIT_PRESETS, VisionTransformer,
                                     load_paddle_tpu_state)

torch.set_num_threads(2)

SHARED = {"add", "conv2d", "flash_attention", "gelu", "getitem",
          "layer_norm", "linear", "reshape"}
JAX_ONLY = {"concat", "expand", "transpose"}


def _pair(seed=3, inf_bias=False):
    paddle.seed(seed)
    jm = JViT(JVIT["vit-tiny"])
    tm = VisionTransformer(VIT_PRESETS["vit-tiny"], device="cpu")
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    if inf_bias:
        state["patch_embed.proj.bias"] = state[
            "patch_embed.proj.bias"].copy()
        state["patch_embed.proj.bias"][0] = np.inf
        jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_paddle_tpu_state(tm, state)
    jm.eval()
    tm.eval()
    return jm, tm


def _image(seed=0):
    return np.random.RandomState(seed).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)


def _run_j(jm, x, level=None):
    if level is None:
        return jm(paddle.to_tensor(x))
    with jamp.auto_cast(level=level):
        return jm(paddle.to_tensor(x))


def _run_t(tm, x, level=None):
    with torch.no_grad():
        if level is None:
            return tm(torch.from_numpy(x))
        with tamp.auto_cast(level=level):
            return tm(torch.from_numpy(x))


@pytest.mark.parametrize("level", [None, "O2"])
def test_operator_stats_match_jax(level, capsys):
    jm, tm = _pair()
    x = _image()
    jd.enable_operator_stats_collection()
    _run_j(jm, x, level)
    jstats = jd.disable_operator_stats_collection(print_table=False)
    with td.collect_operator_stats():
        _run_t(tm, x, level)
    table = capsys.readouterr().out
    assert "flash_attention" in table and "conv2d" in table
    td.enable_operator_stats_collection()
    _run_t(tm, x, level)
    tstats = td.disable_operator_stats_collection(print_table=False)
    assert set(tstats) == SHARED
    assert set(jstats) - set(tstats) == JAX_ONLY
    for name in SHARED:
        assert tstats[name] == jstats[name], name
    low = "bfloat16" if level == "O2" else "float32"
    assert tstats["linear"]["dtypes"] == {low: 13}
    assert tstats["layer_norm"]["dtypes"] == {"float32": 5}
    assert torch._C._len_torch_function_stack() == 0


def test_nan_and_inf_counts_match_jax():
    jm, tm = _pair(inf_bias=True)
    x = _image(1)
    jd.enable_operator_stats_collection()
    _run_j(jm, x)
    jstats = jd.disable_operator_stats_collection(print_table=False)
    td.enable_operator_stats_collection()
    _run_t(tm, x)
    tstats = td.disable_operator_stats_collection(print_table=False)
    assert tstats["conv2d"]["inf"] == jstats["conv2d"]["inf"] == 2 * 16
    for name in SHARED:
        assert (tstats[name]["nan"], tstats[name]["inf"]) == \
            (jstats[name]["nan"], jstats[name]["inf"]), name


def _checker_error(mod, run, model, x, **cfg):
    mod.enable_tensor_checker(mod.TensorCheckerConfig(enable=True, **cfg))
    try:
        run(model, x)
    except FloatingPointError as e:
        return str(e)
    finally:
        mod.disable_tensor_checker()
    return None


SKIP = ["conv2d", "reshape", "add", "layer_norm"]


@pytest.mark.parametrize("jcfg,tcfg,op", [
    ({}, {}, "conv2d"),
    ({"checked_op_list": ["linear"]}, {"checked_op_list": ["linear"]},
     "linear"),
    # JAX also sees (and checks) the ops the port does not
    ({"skipped_op_list": SKIP + sorted(JAX_ONLY)},
     {"skipped_op_list": SKIP}, "linear"),
    # the window counts each package's own ops: JAX's third is transpose,
    # its sixth and the port's third the add of the position embeddings
    ({"debug_step": (6, 100)}, {"debug_step": (3, 100)}, "add"),
])
def test_checker_aborts_on_the_op_jax_names(jcfg, tcfg, op):
    jm, tm = _pair(inf_bias=True)
    x = _image(2)
    jerr = _checker_error(jd, _run_j, jm, x, **jcfg)
    terr = _checker_error(td, _run_t, tm, x, **tcfg)
    assert jerr is not None and terr is not None
    assert f"Operator {op} " in jerr and f"Operator {op} " in terr
    assert torch._C._len_torch_function_stack() == 0
    # disabled: the same forward runs through
    assert not torch.isfinite(_run_t(tm, x)).all()


def test_checker_continue_mode_logs(tmp_path, capsys):
    _, tm = _pair(inf_bias=True)
    out_dir = str(tmp_path / "log")
    td.enable_tensor_checker(td.TensorCheckerConfig(
        enable=True, debug_mode=td.DebugMode.CHECK_NAN_INF,
        output_dir=out_dir))
    try:
        y = _run_t(tm, _image(3))
    finally:
        td.disable_tensor_checker()
    assert y.shape == (2, 10)
    assert "[tensor_checker] op 'conv2d'" in capsys.readouterr().out
    lines = open(os.path.join(out_dir, "tensor_checker.log")).read()
    assert lines.startswith("conv2d: Operator conv2d output contains NaN")
    # the same under auto_cast: the two modes stack and unstack
    td.enable_tensor_checker(td.TensorCheckerConfig(enable=True))
    try:
        with pytest.raises(FloatingPointError, match="conv2d"):
            _run_t(tm, _image(3), "O1")
    finally:
        td.disable_tensor_checker()
    assert torch._C._len_torch_function_stack() == 0


def test_disable_in_another_nesting_raises():
    """Statistics turned on outside an ``auto_cast`` and off inside it would
    pop the autocast mode: the disable raises and leaves both modes and the
    statistics as they were; turned off where they were turned on, they
    leave torch's stack empty."""
    td.enable_operator_stats_collection()
    with tamp.auto_cast():
        with pytest.raises(RuntimeError, match="nesting"):
            td.disable_operator_stats_collection(print_table=False)
        assert torch._C._len_torch_function_stack() == 2
        torch.ones(2) + 1
    stats = td.disable_operator_stats_collection(print_table=False)
    assert stats["add"]["calls"] == 1
    assert torch._C._len_torch_function_stack() == 0


def test_check_numerics_matches_jax():
    a = np.array([0.0, 1.0, np.inf, np.nan, 0.0, -np.inf], np.float32)
    with pytest.raises(FloatingPointError, match="op:x"):
        td.check_numerics(torch.from_numpy(a), "op", "x")
    want = jd.check_numerics(paddle.to_tensor(a), "op", "x",
                             debug_mode=jd.DebugMode.CHECK_NAN_INF)
    got = td.check_numerics(torch.from_numpy(a), "op", "x",
                            debug_mode=td.DebugMode.CHECK_NAN_INF)
    assert [int(g) for g in got] == [int(np.asarray(w.numpy()))
                                     for w in want] == [1, 2, 2]
    got = td.check_numerics(torch.tensor([0, 3, 0]))
    assert [int(g) for g in got] == [0, 0, 2]


def test_compare_accuracy_matches_jax(tmp_path):
    _, tm = _pair()
    _, tbad = _pair(inf_bias=True)
    dumps = []
    for i, model in enumerate((tm, tbad)):
        td.enable_operator_stats_collection()
        _run_t(model, _image(4))
        path = str(tmp_path / f"run{i}.json")
        td.save_stats(td.disable_operator_stats_collection(False), path)
        dumps.append(path)
    trows = td.compare_accuracy(*dumps, str(tmp_path / "t.json"))
    jrows = jd.compare_accuracy(*dumps, str(tmp_path / "j.json"))
    assert trows == jrows and {r["op"] for r in trows} >= {"conv2d",
                                                             "linear"}
    assert json.load(open(tmp_path / "t.json")) == json.load(
        open(tmp_path / "j.json"))
