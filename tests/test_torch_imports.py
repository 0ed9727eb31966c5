"""The port stands alone: it imports neither ``jax`` nor ``paddle_tpu``,
and its entry points refuse to fall back to the CPU silently."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch

from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     Mamba2Config, Mamba2ForCausalLM,
                                     MambaConfig, MambaForCausalLM,
                                     MoELlamaConfig, MoELlamaForCausalLM,
                                     RwkvConfig, RwkvForCausalLM)
from paddle_tpu_torch.ops.fused.grouped_gemm import (grouped_matmul,
                                                     grouped_matmul_swiglu,
                                                     grouped_matmul_tgmm)
from paddle_tpu_torch.parallel import GShardGate, MLPExperts, MoELayer
from paddle_tpu_torch.optimizer import AdamW, FusedAdamW
from paddle_tpu_torch.serving import ServingConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")

TINY = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                   num_hidden_layers=1, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=32,
                   dtype="float32")


def _forbidden(module: str) -> bool:
    # paddle_tpu_torch shares the prefix and is allowed
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_no_forbidden_imports_in_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_import_leaves_jax_and_paddle_tpu_unloaded():
    code = (
        "import sys, pkgutil, importlib, paddle_tpu_torch\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print(' '.join(sorted(m for m in sys.modules\n"
        "               if m.split('.')[0] in %r)))\n" % (FORBIDDEN,))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_walk_covers_the_training_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.jit", "paddle_tpu_torch.optimizer.adam",
            "paddle_tpu_torch.optimizer.fused",
            "paddle_tpu_torch.ops.cuda.fused_adamw",
            "paddle_tpu_torch.ops.fused.cross_entropy"} <= names


def test_walk_covers_the_quantized_serving_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.ops.quant_ops",
            "paddle_tpu_torch.ops.cuda.int8_matmul",
            "paddle_tpu_torch.models.kv_cache"} <= names
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "int8_matmul.cu").is_file()


@pytest.mark.parametrize("quantize,kv_dtype", [
    ("int8", ""), ("int4", ""), (False, "int8"), (True, "int8")])
def test_quantized_modes_no_longer_raise(monkeypatch, quantize, kv_dtype):
    """The quantized modes serve on the CPU when asked for it, and still
    refuse a CUDA device without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = LlamaConfig(**{**TINY.__dict__, "hidden_size": 128,
                         "intermediate_size": 128})
    model = LlamaForCausalLM(cfg, device="cpu")
    sc = ServingConfig(max_seq_len=32, block_size=8, quantize=quantize,
                       kv_cache_dtype=kv_dtype)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, sc, device="cuda")
    eng = ServingEngine(model, sc)
    assert len(eng.generate_batch([np.arange(5)], max_new_tokens=3)[0]) == 3
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        ServingEngine(model, ServingConfig(max_seq_len=32,
                                           kv_cache_dtype="int4"))


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(TINY)
    model = LlamaForCausalLM(TINY, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, ServingConfig(max_seq_len=32), device="cuda")
    eng = ServingEngine(model, ServingConfig(max_seq_len=32, block_size=8))
    assert eng.device.type == "cpu"
    assert len(eng.generate_batch([np.arange(5)], max_new_tokens=3)[0]) == 3
    # the training path: the model, TrainStep and the optimizers
    train_cfg = LlamaConfig(**{**TINY.__dict__, "fused_loss": True})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(train_cfg)
    model = LlamaForCausalLM(train_cfg, device="cpu")
    for make in (lambda: AdamW(parameters=model.parameters(), device="cuda"),
                 lambda: FusedAdamW(parameters=model.parameters(),
                                    device="cuda"),
                 lambda: TrainStep(model, None,
                                   AdamW(parameters=model.parameters()),
                                   device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ids = torch.from_numpy(np.arange(12).reshape(2, 6))
    step = TrainStep(model, None, AdamW(parameters=model.parameters(),
                                        device="cpu"), clip_norm=1.0)
    assert step.device.type == "cpu" and torch.isfinite(step(ids, ids))
    opt = FusedAdamW(parameters=model.parameters(), device="cpu")
    model(ids, labels=ids)[0].backward()
    opt.step()
    assert opt._flat.device.type == "cpu" and opt._step_count == 1


def test_walk_covers_the_moe_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.parallel", "paddle_tpu_torch.parallel.moe",
            "paddle_tpu_torch.models.moe_llm",
            "paddle_tpu_torch.ops.cuda.grouped_gemm",
            "paddle_tpu_torch.ops.fused.grouped_gemm"} <= names
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "grouped_gemm.cu").is_file()


def test_moe_entry_points_raise_without_cuda(monkeypatch):
    """The MoE model, its gates and experts refuse a CUDA device without a
    card and train on the CPU when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = MoELlamaConfig(**{**TINY.__dict__, "num_hidden_layers": 2,
                            "moe_num_experts": 4, "fused_loss": True})
    for make in (lambda: MoELlamaForCausalLM(cfg),
                 lambda: MoELlamaForCausalLM(cfg, device="cuda"),
                 lambda: GShardGate(32, 4),
                 lambda: MLPExperts(4, 32, 48, activation="swiglu")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    model = MoELlamaForCausalLM(cfg, device="cpu")
    assert [type(l.mlp).__name__ for l in model.layers] == ["LlamaMLP",
                                                           "MoELayer"]
    ids = torch.from_numpy(np.arange(12).reshape(2, 6))
    step = TrainStep(model, None, AdamW(parameters=model.parameters()),
                     clip_norm=1.0)
    assert torch.isfinite(step(ids, ids))
    moe = model.moe_layers()[0]
    assert isinstance(moe, MoELayer) and moe.use_grouped()
    assert int(moe.expert_load.sum()) == 2 * 12


def test_grouped_gemms_refuse_other_devices():
    """The grouped GEMMs run their plain versions only for CPU tensors:
    another device raises instead of falling back."""
    x = torch.empty(8, 16, device="meta")
    sizes = torch.empty(2, dtype=torch.int32, device="meta")
    for call in (lambda: grouped_matmul(x, torch.empty(2, 16, 8,
                                                       device="meta"), sizes),
                 lambda: grouped_matmul_tgmm(x, x, sizes),
                 lambda: grouped_matmul_swiglu(
                     x, torch.empty(2, 16, 16, device="meta"), sizes,
                     torch.empty(2, 16, device="meta"))):
        with pytest.raises(ValueError, match="CPU or on one CUDA device"):
            call()


def test_walk_covers_the_ssm_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.models.mamba", "paddle_tpu_torch.models.rwkv",
            "paddle_tpu_torch.ops.cuda.selective_scan",
            "paddle_tpu_torch.ops.cuda.wkv",
            "paddle_tpu_torch.ops.fused.rwkv"} <= names
    for src in ("selective_scan.cu", "wkv.cu"):
        assert (ROOT / "paddle_tpu_torch" / "csrc" / src).is_file()


def test_ssm_entry_points_raise_without_cuda(monkeypatch):
    """Mamba and RWKV refuse a CUDA device without a card (also when no
    device is named) and train on the CPU when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mamba = MambaConfig(vocab_size=64, hidden_size=32, num_hidden_layers=1)
    rwkv = RwkvConfig(vocab_size=64, hidden_size=64, num_hidden_layers=1,
                      head_dim=64)
    for make in (lambda: MambaForCausalLM(mamba),
                 lambda: MambaForCausalLM(mamba, device="cuda"),
                 lambda: RwkvForCausalLM(rwkv),
                 lambda: RwkvForCausalLM(rwkv, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    ids = torch.from_numpy(np.arange(12).reshape(2, 6))
    for model in (MambaForCausalLM(mamba, device="cpu"),
                  RwkvForCausalLM(rwkv, device="cpu")):
        step = TrainStep(model, None, AdamW(parameters=model.parameters()),
                         clip_norm=1.0)
        assert step.device.type == "cpu" and torch.isfinite(step(ids, ids))


def test_walk_covers_the_mamba2_modules():
    names = {m.name for m in pkgutil.walk_packages(
        paddle_tpu_torch.__path__, "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.models.mamba2",
            "paddle_tpu_torch.ops.cuda.ssd",
            "paddle_tpu_torch.ops.fused.ssd"} <= names
    assert (ROOT / "paddle_tpu_torch" / "csrc" / "ssd.cu").is_file()


def test_mamba2_entry_points_raise_without_cuda(monkeypatch):
    """Mamba-2 refuses a CUDA device without a card (also when no device is
    named) and trains on the CPU when asked to."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Mamba2Config(vocab_size=64, hidden_size=64, num_hidden_layers=1,
                       ssd_chunk=4)
    for make in (lambda: Mamba2ForCausalLM(cfg),
                 lambda: Mamba2ForCausalLM(cfg, device="cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    model = Mamba2ForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(np.arange(12).reshape(2, 6))
    step = TrainStep(model, None, AdamW(parameters=model.parameters()),
                     clip_norm=1.0)
    assert step.device.type == "cpu" and torch.isfinite(step(ids, ids))
