"""The port's fused transformer and Llama model against the JAX package on
the CPU, in f32, with the JAX model's weights loaded into the port through
``load_paddle_tpu_state``.

Tolerances: hidden states and caches 2e-5 absolute, whole-model logits
1e-4 absolute (f32 sums in another order across the layers). The bf16
decoder layer: at most 0.2% of its outputs may differ from JAX's, each by
at most one bf16 ulp of the output's scale (the matrix products sum in
another order; the norms and swiglu round bit for bit as JAX's, where the
f32-rounding versions differ at 1.2% of them).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional.fused_transformer import (
    fused_multi_transformer as jax_fmt,
    fused_multi_transformer_paged_ragged as jax_fmt_paged,
    fused_weights_from_llama as jax_fused_weights)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlama
from paddle_tpu.ops.fused.rope import build_rope_cache as jax_rope_cache
from paddle_tpu_torch.incubate.nn.functional import (
    fused_multi_transformer, fused_multi_transformer_paged_ragged,
    fused_weights_from_llama)
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                     load_paddle_tpu_state)
from paddle_tpu_torch.ops.fused.rope import build_rope_cache

torch.set_num_threads(2)

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
HQ, HK, DH, L = 4, 2, 16, 2
EPS = 1e-5


def state_numpy(jax_model):
    return {k: np.asarray(v.numpy()) for k, v in
            jax_model.state_dict().items()}


def make_pair(seed):
    """A JAX tiny Llama and the port's copy of it (CPU)."""
    paddle.seed(seed)
    jm = JaxLlama(JaxLlamaConfig(**TINY))
    jm.eval()
    tm = LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")
    load_paddle_tpu_state(tm, state_numpy(jm))
    return jm, tm


@pytest.fixture(scope="module")
def pair():
    return make_pair(5)


@pytest.mark.parametrize("s,offset", [(16, 0), (16, 11), (4, 9)])
def test_fused_multi_transformer_matches_jax(pair, s, offset):
    """s = 16 runs the flash branch (causal, q_offset = offset); s = 4 the
    dense s <= 8 branch."""
    jm, tm = pair
    rng = np.random.RandomState(4)
    s_max = 48
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    ck = np.zeros((L, 2, s_max, HK, DH), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :, :offset] = rng.standard_normal((L, 2, offset, HK, DH))
    cv[:, :, :offset] = rng.standard_normal((L, 2, offset, HK, DH))
    cos, sin = build_rope_cache(s_max, DH)
    jcos, jsin = jax_rope_cache(s_max, DH)
    h, nk, nv = fused_multi_transformer(
        torch.from_numpy(x), fused_weights_from_llama(tm),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), offset,
        cos[offset:offset + s], sin[offset:offset + s], HQ, HK, EPS)
    jh, jk, jv = jax_fmt(jnp.asarray(x), jax_fused_weights(jm),
                         jnp.asarray(ck), jnp.asarray(cv), offset,
                         jcos[offset:offset + s], jsin[offset:offset + s],
                         HQ, HK, EPS)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-5)
    np.testing.assert_allclose(nk.numpy(), np.asarray(jk), atol=2e-5)
    np.testing.assert_allclose(nv.numpy(), np.asarray(jv), atol=2e-5)


def test_paged_ragged_decode_matches_jax(pair):
    """Per-row tables and lengths, including an idle row (len 0, null
    table) and a row whose token lands on a page boundary."""
    jm, tm = pair
    rng = np.random.RandomState(6)
    page, pps, blocks = 8, 4, 14
    lens = np.array([5, 0, 16, 23], np.int32)
    table = np.zeros((4, pps), np.int32)
    ids = list(rng.permutation(np.arange(1, blocks)))
    for i, n in enumerate(lens):
        for j in range(n // page + 1 if n else 0):
            table[i, j] = ids.pop()
    kp = rng.standard_normal((L, HK, blocks, page, DH)).astype(np.float32)
    vp = rng.standard_normal((L, HK, blocks, page, DH)).astype(np.float32)
    x = rng.standard_normal((4, 1, 64)).astype(np.float32)
    cos, sin = build_rope_cache(64, DH)
    jcos, jsin = jax_rope_cache(64, DH)
    h, nk, nv = fused_multi_transformer_paged_ragged(
        torch.from_numpy(x), fused_weights_from_llama(tm),
        torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy()),
        torch.from_numpy(table), torch.from_numpy(lens),
        cos[lens][:, None], sin[lens][:, None], HQ, HK, EPS)
    jh, jk, jv = jax_fmt_paged(
        jnp.asarray(x), jax_fused_weights(jm), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(table), jnp.asarray(lens),
        jcos[lens][:, None], jsin[lens][:, None], HQ, HK, EPS,
        interpret=True)
    live = lens > 0        # an idle row's output is garbage the engine drops
    np.testing.assert_allclose(h.numpy()[live], np.asarray(jh)[live],
                               atol=2e-5)
    # the commit: every live row's k/v landed at (table[len // page],
    # len % page) and nothing else moved (block 0 takes the idle row)
    np.testing.assert_allclose(nk.numpy()[:, :, 1:], np.asarray(jk)[:, :, 1:],
                               atol=2e-5)
    np.testing.assert_allclose(nv.numpy()[:, :, 1:], np.asarray(jv)[:, :, 1:],
                               atol=2e-5)
    assert not np.array_equal(nk.numpy(), kp)


def test_llama_logits_match_jax(pair):
    jm, tm = pair
    ids = np.random.RandomState(7).randint(0, 256, (2, 24))
    ours = tm(torch.from_numpy(ids)).detach().numpy()   # trainable model
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    assert ours.shape == ref.shape == (2, 24, 256)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_load_state_rejects_mismatch(pair):
    jm, tm = pair
    state = state_numpy(jm)
    state.pop("lm_head.weight")
    with pytest.raises(KeyError, match="lm_head.weight"):
        load_paddle_tpu_state(tm, state)
    state = state_numpy(jm)
    state["model.norm.weight"] = state["model.norm.weight"][:-1]
    with pytest.raises(ValueError, match="model.norm.weight"):
        load_paddle_tpu_state(tm, state)


def test_bf16_decoder_layer_rounds_as_jax():
    """One decoder layer in bf16, with norm weights away from one so the
    weight multiply rounds: the port's layer rounds where the JAX model
    does (the norm casts before the weight, swiglu runs in bf16)."""
    cfg = dict(TINY, num_hidden_layers=1, dtype="bfloat16")
    paddle.seed(8)
    jm = JaxLlama(JaxLlamaConfig(**cfg))
    rng = np.random.RandomState(9)
    state = {k: np.asarray(v.astype("float32").numpy())
             for k, v in jm.state_dict().items()}
    for k in state:
        if k.endswith("norm.weight"):
            state[k] = (1 + 0.5 * rng.standard_normal(state[k].shape)
                        ).astype(np.float32)
    jm.set_state_dict({k: paddle.to_tensor(v).astype("bfloat16")
                       for k, v in state.items()})
    tm = LlamaForCausalLM(LlamaConfig(**cfg), device="cpu")
    load_paddle_tpu_state(tm, state)
    x = (rng.standard_normal((2, 16, 64)) * 3).astype(np.float32)
    jx = paddle.to_tensor(x).astype("bfloat16")
    ref = np.asarray(jm.model.layers[0](
        jx, jm.model.rope_cos[:16], jm.model.rope_sin[:16]
    ).astype("float32").numpy())
    with torch.no_grad():
        ours = tm.model.layers[0](
            torch.from_numpy(x).bfloat16(), tm.model.rope_cos[:16],
            tm.model.rope_sin[:16]).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    diff = np.abs(ours - ref)
    assert diff.max() <= ulp
    assert (diff > 0).mean() <= 0.002, (diff > 0).mean()


def _loading_pairs():
    """(name, JAX model, port model) of each family the port trains."""
    from paddle_tpu.models import MambaConfig as JaxMambaConfig
    from paddle_tpu.models import MambaForCausalLM as JaxMamba
    from paddle_tpu.models import MoELlamaConfig as JaxMoEConfig
    from paddle_tpu.models import MoELlamaForCausalLM as JaxMoE
    from paddle_tpu.models import RwkvConfig as JaxRwkvConfig
    from paddle_tpu.models import RwkvForCausalLM as JaxRwkv
    from paddle_tpu_torch.models import (MambaConfig, MambaForCausalLM,
                                         MoELlamaConfig, MoELlamaForCausalLM,
                                         RwkvConfig, RwkvForCausalLM)

    moe = dict(TINY, num_hidden_layers=2, moe_num_experts=4)
    mamba = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                 dtype="float32")
    rwkv = dict(vocab_size=64, hidden_size=128, num_hidden_layers=1,
                head_dim=64, dtype="float32")
    paddle.seed(11)
    return [
        ("llama", JaxLlama(JaxLlamaConfig(**TINY)),
         LlamaForCausalLM(LlamaConfig(**TINY), device="cpu")),
        ("moe", JaxMoE(JaxMoEConfig(**moe)),
         MoELlamaForCausalLM(MoELlamaConfig(**moe), device="cpu")),
        ("mamba", JaxMamba(JaxMambaConfig(**mamba)),
         MambaForCausalLM(MambaConfig(**mamba), device="cpu")),
        ("rwkv", JaxRwkv(JaxRwkvConfig(**rwkv)),
         RwkvForCausalLM(RwkvConfig(**rwkv), device="cpu")),
    ]


def test_load_state_transposes_linear_modules_of_every_family():
    """Every family's JAX state dict loads: exactly the weights of the
    port's ``nn.Linear`` modules are transposed (RWKV's ``head.weight`` and
    Mamba's ``x_proj``/``dt_proj`` too, the MoE gate and expert stacks and
    Mamba's conv ``[d, 1, k]`` not), and a missing, unexpected or
    mis-shaped name raises."""
    for name, jm, tm in _loading_pairs():
        state = state_numpy(jm)
        load_paddle_tpu_state(tm, state)
        linear = {f"{n}.weight" for n, m in tm.named_modules()
                  if isinstance(m, torch.nn.Linear)}
        assert linear, name
        for pname, p in tm.named_parameters():
            ref = state[pname].T if pname in linear else state[pname]
            np.testing.assert_array_equal(p.detach().numpy(), ref,
                                          err_msg=f"{name} {pname}")
        some = sorted(linear)[0]
        bad = dict(state)
        bad.pop(some)
        with pytest.raises(KeyError, match="missing"):
            load_paddle_tpu_state(tm, bad)
        with pytest.raises(KeyError, match="unexpected"):
            load_paddle_tpu_state(tm, {**state, "extra.weight": state[some]})
        bad = dict(state)
        bad[some] = bad[some].T          # the PyTorch layout is refused
        if bad[some].shape != state[some].shape:
            with pytest.raises(ValueError, match=some):
                load_paddle_tpu_state(tm, bad)


# ------------------------------------------------- Llama training surface
def test_presets_match_jax():
    """Every preset, ``llama-350m`` and ``llama-1b`` among them, equals the
    JAX one field by field (the two configs have the same fields)."""
    from dataclasses import asdict

    from paddle_tpu.models.llama import LLAMA_PRESETS as JAX_PRESETS
    from paddle_tpu_torch.models.llama import LLAMA_PRESETS

    assert sorted(LLAMA_PRESETS) == sorted(JAX_PRESETS)
    assert {"llama-350m", "llama-1b"} <= set(LLAMA_PRESETS)
    for name, cfg in LLAMA_PRESETS.items():
        assert asdict(cfg) == asdict(JAX_PRESETS[name]), name
        assert cfg.num_params() == JAX_PRESETS[name].num_params(), name


def test_tied_llama_matches_jax():
    """``tie_word_embeddings``: no ``lm_head``, the parameter count without
    the head, and the logits and the loss (both loss paths) through the
    embedding matrix, against the JAX model."""
    paddle.seed(9)
    jm = JaxLlama(JaxLlamaConfig(**TINY, tie_word_embeddings=True))
    jm.eval()
    cfg = LlamaConfig(**TINY, tie_word_embeddings=True)
    tm = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_state(tm, state_numpy(jm))
    assert tm.lm_head is None and tm.head_weight is \
        tm.model.embed_tokens.weight
    assert cfg.num_params() == jm.config.num_params() \
        == sum(p.numel() for p in tm.parameters()) \
        == LlamaConfig(**TINY).num_params() - 256 * 64
    ids = np.random.RandomState(10).randint(0, 256, (2, 24))
    labels = ids.copy()
    labels[0, 3] = -100
    with torch.no_grad():
        np.testing.assert_allclose(
            tm(torch.from_numpy(ids)).numpy(),
            np.asarray(jm(paddle.to_tensor(ids)).numpy()), atol=1e-4)
        for fused in (False, True):
            jm.config.fused_loss = tm.config.fused_loss = fused
            jloss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            tloss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
            np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def _packed(rng, b, s):
    """Segment ids (3-6 segments a row), positions restarting at each
    segment, as a packed-varlen batch carries them."""
    seg = np.zeros((b, s), np.int32)
    pos = np.zeros((b, s), np.int64)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, s), rng.randint(2, 6),
                                  replace=False))
        seg[i] = np.searchsorted(cuts, np.arange(s), side="right")
        starts = np.concatenate([[0], cuts])
        pos[i] = np.arange(s) - starts[seg[i]]
    return seg, pos


@pytest.mark.parametrize("kind", ["additive_4d", "bool_2d", "packed"])
def test_masked_and_packed_logits_match_jax(pair, kind):
    """``attn_mask`` (additive ``[b, 1, s, s]``, bool ``[s, s]`` with the
    diagonal kept), and ``segment_ids`` with ``position_ids`` restarting per
    segment: the logits against the JAX model (its dense flash path on the
    CPU, which takes 2- and 4-D masks; the 3-D form is held against the
    Pallas kernel in ``test_torch_flash_mask.py``), and each packed segment
    against the same tokens run alone."""
    jm, tm = pair
    rng = np.random.RandomState(12)
    b, s = 2, 24
    ids = rng.randint(0, 256, (b, s))
    kw = {}
    if kind == "additive_4d":
        kw["attn_mask"] = rng.standard_normal((b, 1, s, s)).astype(np.float32)
    elif kind == "bool_2d":
        m = rng.random_sample((s, s)) > 0.4
        m[np.arange(s), np.arange(s)] = True
        kw["attn_mask"] = m
    else:
        kw["segment_ids"], kw["position_ids"] = _packed(rng, b, s)
    ours = tm(torch.from_numpy(ids), **{k: torch.from_numpy(v)
                                        for k, v in kw.items()})
    ref = jm(paddle.to_tensor(ids), **{k: paddle.to_tensor(v)
                                       for k, v in kw.items()})
    np.testing.assert_allclose(ours.detach().numpy(),
                               np.asarray(ref.numpy()), atol=1e-4)
    if kind == "packed":
        # each segment alone, at positions from 0, gives the same logits
        seg = kw["segment_ids"][0]
        for sid in np.unique(seg):
            cols = np.flatnonzero(seg == sid)
            alone = tm(torch.from_numpy(ids[:1, cols]))
            np.testing.assert_allclose(alone.detach().numpy()[0],
                                       ours.detach().numpy()[0, cols],
                                       atol=1e-4)


def test_positions_past_the_rope_table_raise(pair):
    _, tm = pair
    ids = torch.zeros(1, TINY["max_position_embeddings"] + 1,
                      dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        tm(ids)


def test_context_parallel_runs_flash(pair):
    """``context_parallel=True`` without a mesh (the port has none until
    ROADMAP A8) runs flash attention: the same logits as ``False``."""
    jm, _ = pair
    ids = torch.from_numpy(np.random.RandomState(13).randint(0, 256, (2, 20)))
    out = []
    for cp in (False, True):
        tm = LlamaForCausalLM(LlamaConfig(**TINY, context_parallel=cp),
                              device="cpu")
        load_paddle_tpu_state(tm, state_numpy(jm))
        out.append(tm(ids).detach())
    assert torch.equal(out[0], out[1])


def test_serving_engine_on_tied_model_matches_dense_greedy():
    """The serving engine reads the head from the embedding matrix of a
    tied model: its streamed tokens are the dense forward's greedy argmax,
    teacher-forced."""
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    tm = LlamaForCausalLM(LlamaConfig(**TINY, tie_word_embeddings=True),
                          device="cpu", seed=14)
    tm.eval()
    eng = ServingEngine(tm, ServingConfig(max_seq_len=64, block_size=8))
    prompt = np.arange(3, 22, dtype=np.int32)
    toks = list(eng.stream(eng.submit(prompt, 8)))
    with torch.no_grad():
        logits = tm(torch.tensor(np.concatenate([prompt, toks])[None]))
    assert logits[0, len(prompt) - 1:-1].argmax(-1).tolist() == toks
