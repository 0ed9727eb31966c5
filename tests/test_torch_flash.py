"""The flash attention oracles at the edges of the card's tiles, on the CPU.

The wgmma flash kernels (``paddle_tpu_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``) work on 128-row q and kv tiles in 64-row
warpgroup halves and take a mask only on tiles that straddle the causal
diagonal, ``kv_len`` or the end of the rows. ``chip_smoke.py`` holds them
against the plain ``flash_attn_reference`` and ``flash_attn_bwd_reference``;
here those plain versions are held against the Pallas ``_fwd`` (its lse)
and ``_bwd`` (``jax.grad`` through ``flash_attention_bhsd``), both in
interpret mode, at the shapes where the tiles' edges fall: two batches with
sq and sk off every multiple of 64, ``q_offset`` off the 16-row boundaries,
``kv_len`` inside the last tile, GQA groups of 4, d = 64 and 128, and a
negative ``q_offset`` that empties rows. Same seeded numpy inputs in f32;
tolerances as ``test_torch_kernels.py``: outputs 2e-5, lse 1e-5 relative,
gradients 1e-4 absolute.

The wrappers' one decision in Python, the refusal of a tensor that does not
start on a 16-byte boundary (TMA's rule), is tested on CPU tensors and on
the views that serving prefill hands to the flash entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as jax_pallas_flash
from paddle_tpu.ops.pallas.flash_attention import flash_attention_bhsd
from paddle_tpu_torch.incubate.nn.functional import fused_transformer
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.kv_cache import KVCacheSpec
from paddle_tpu_torch.ops.cuda.flash_attention import misaligned
from paddle_tpu_torch.ops.fused.flash_attention import (
    EMPTY_ROW_LSE, flash_attention, flash_attn_bwd_reference,
    flash_attn_reference)
from paddle_tpu_torch.ops.fused.rope import build_rope_cache

torch.set_num_threads(2)

ATOL = 2e-5
LSE_RTOL = 1e-5
GRAD_ATOL = 1e-4

# (b, sq, sk, hq, hk, d, causal, q_offset, kv_len)
EDGE_CASES = {
    # sq = 70, sk = 83: the second 64-row half of a q tile and the kv tile
    # both ragged; the diagonal 13 columns right of the 16-row grid
    "ragged_b2_d64_offset13": (2, 70, 83, 4, 4, 64, True, 13, None),
    # GQA group 4, kv_len = 90 inside the last 64 columns, offset 5
    "gqa4_d128_kv_len_in_tile": (2, 70, 96, 4, 1, 128, True, 5, 90),
    # non-causal GQA with kv_len 140 of 150, sq = 33
    "gqa4_d64_noncausal_kv_len": (2, 33, 150, 8, 2, 64, False, None, 140),
    # rows 0-8 see no column (c <= r - 9)
    "negative_offset_empty_rows": (2, 40, 40, 4, 2, 128, True, -9, None),
}


def _inputs(case, seed=5):
    b, sq, sk, hq, hk, d, causal, q_offset, kv_len = EDGE_CASES[case]
    rng = np.random.RandomState(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, sq, hq, d), (b, sk, hk, d), (b, sk, hk, d),
                            (b, sq, hq, d))]
    return arrays, dict(causal=causal, q_offset=q_offset, kv_len=kv_len)


def _bhsd(a):
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


def _pallas_lse(q, k, v, causal, q_offset, kv_len):
    """The Pallas forward's lse ``[b, h, sq]`` (``_fwd`` in interpret mode,
    padded as ``flash_attention_bhsd`` pads)."""
    qt, kt, vt = _bhsd(q), _bhsd(k), _bhsd(v)
    sq, sk, d = q.shape[1], k.shape[1], q.shape[3]
    kv_len = sk if kv_len is None else kv_len
    q_offset = kv_len - sq if q_offset is None else q_offset
    bq, bk = jax_pallas_flash._block_sizes(sq, sk, d, causal, dtype=qt.dtype)
    pad = lambda a, n: jnp.pad(  # noqa: E731
        a, ((0, 0), (0, 0), (0, (-a.shape[2]) % n), (0, 0)))
    _, lse = jax_pallas_flash._fwd(
        pad(qt, bq), pad(kt, bk), pad(vt, bk), None, None, None, None,
        d ** -0.5, causal, q_offset, kv_len, bq, bk, 0.0, True)
    return np.asarray(lse)[:, :, :sq, 0]


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_flash_oracles_match_pallas_at_tile_edges(case):
    (q, k, v, do), kw = _inputs(case)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = flash_attn_reference(tq, tk, tv, return_lse=True, **kw)
    ref_lse = _pallas_lse(q, k, v, **kw)
    np.testing.assert_allclose(lse.numpy(), ref_lse, rtol=LSE_RTOL)
    empty = ref_lse < -1e29
    assert empty.any() == (case == "negative_offset_empty_rows")
    assert np.all(lse.numpy()[empty] == np.float32(EMPTY_ROW_LSE))

    def fwd(q_, k_, v_):
        return flash_attention_bhsd(q_, k_, v_, interpret=True, **kw)

    pallas_out, vjp = jax.vjp(fwd, _bhsd(q), _bhsd(k), _bhsd(v))
    # rows that see nothing: the port writes zeros, Pallas the mean of v
    # over the blocks it visits (exp2(NEG_INF - NEG_INF) = 1)
    seen = ~empty.transpose(0, 2, 1)[..., None]            # [b, sq, hq, 1]
    np.testing.assert_allclose(
        np.where(seen, out.numpy(), 0),
        np.where(seen, np.asarray(jnp.swapaxes(pallas_out, 1, 2)), 0),
        atol=ATOL)
    assert np.all(out.numpy()[~np.broadcast_to(seen, out.shape)] == 0)

    grads = vjp(_bhsd(do))
    ours = flash_attn_bwd_reference(tq, tk, tv, out, lse, tdo, **kw)
    for name, g, r in zip("qkv", ours, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jnp.swapaxes(r, 1, 2)),
                                   atol=GRAD_ATOL, err_msg=f"d{name}")
    if empty.any():
        rows = empty.any(axis=(0, 1))
        assert np.all(ours[0].numpy()[:, rows] == 0)


def test_misaligned_names_views_off_16_bytes():
    base = torch.zeros(64, dtype=torch.bfloat16)
    assert misaligned([("q", base), ("k", base[8:])]) == []
    assert misaligned([("q", base[1:]), ("k", base), ("v", base[4:])]) \
        == ["q", "v"]


def test_serving_prefill_hands_flash_aligned_views(monkeypatch):
    """Serving prefill allocates its scratch cache with
    ``KVCacheSpec.alloc_dense`` (``[L, 1, S, hk, d]`` bf16) and passes
    ``cache_k[i]``, ``cache_v[i]`` and the step's q of every layer to the
    flash entry: every view it hands over starts on a 16-byte boundary, at
    a carried offset and a bucket that are not multiples of 8."""
    cfg = LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=96,
                      num_hidden_layers=3, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      dtype="bfloat16")
    torch.manual_seed(0)
    model = LlamaForCausalLM(cfg, device="cpu")
    offset, s = 5, 19
    ck, cv = KVCacheSpec.from_config(cfg).alloc_dense(1, offset + s, "cpu")
    seen = []

    def spy(q, k, v, **kw):
        seen.append([("q", q), ("cache_k[i]", k), ("cache_v[i]", v)])
        return flash_attention(q, k, v, **kw)

    monkeypatch.setattr(fused_transformer, "flash_attention", spy)
    cos, sin = build_rope_cache(offset + s, cfg.head_dim)
    x = torch.randn(1, s, 64).bfloat16()
    fused_transformer.fused_multi_transformer(
        x, fused_transformer.fused_weights_from_llama(model), ck, cv, offset,
        cos[offset:], sin[offset:], num_heads=4, num_kv_heads=2)
    assert len(seen) == cfg.num_hidden_layers
    assert [misaligned(views) for views in seen] == [[]] * len(seen)
    assert [k.data_ptr() for _, (_, k), _ in seen] == \
        [ck[i].data_ptr() for i in range(cfg.num_hidden_layers)]
