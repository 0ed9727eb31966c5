"""Fused whole-decoder serving path — the counterpart of
``paddle_tpu/incubate/nn/functional/fused_transformer.py``.

Per-layer weights are stacked on a leading layer axis (``[L, …]``, qkv
packed ``[q | k | v]`` and ffn1 packed ``[gate | up]`` on the output dim,
in the JAX ``[in, out]`` layout), and the layer loop is a Python loop.
The matrix products stay ``torch.matmul``, or, with weight-only int8/int4
weights, go through the weight-only GEMM (``ops/cuda/int8_matmul.py``);
attention goes through the flash dispatch (prefill) and the paged decode
kernel (decode and the speculative verify window, over bf16 or int8
pages; ``fused_multi_transformer_paged``: decode over the contiguous
layout, where sequence b owns pages ``[b * pps, (b + 1) * pps)``).

Caches are updated IN PLACE: where the JAX code threads new cache arrays
out of a ``lax.scan`` and relies on buffer donation, these functions write
into the tensors they were given (``index_put_`` through indexed
assignment) and return the same tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from ....models.kv_cache import dequantize_kv, quantize_kv
from ....nn.functional import rms_norm_f32, swiglu_f32
from ....ops.cuda.int8_matmul import (int4_weight_matmul, int8_weight_matmul,
                                      pack_int4)
from ....ops.cuda.paged_attention import paged_attention
from ....ops.fused.flash_attention import flash_attention
from ....ops.fused.rope import apply_rotary_position_embedding as _rope
from ....ops.quant_ops import weight_quantize

__all__ = ["FusedTransformerWeights", "fused_weights_from_llama",
           "fused_multi_transformer", "fused_multi_transformer_paged",
           "fused_multi_transformer_paged_ragged",
           "fused_multi_transformer_paged_ragged_verify",
           "paged_cache_from_dense", "contiguous_page_table"]


@dataclass
class FusedTransformerWeights:
    """Per-layer weights stacked on axis 0 (length L). With weight-only
    quantization the four weight stacks are int8 (int4: packed
    ``[L, K/2, N]``) with f32 per-output-channel scales (``*_scale``)."""

    ln_scale: torch.Tensor      # [L, D]
    qkv_w: torch.Tensor         # [L, D, (h + 2*hk) * dh]
    out_w: torch.Tensor         # [L, h*dh, D]
    ffn_ln_scale: torch.Tensor  # [L, D]
    ffn1_w: torch.Tensor        # [L, D, 2*I]  (gate | up)
    ffn2_w: torch.Tensor        # [L, I, D]
    qkv_scale: Optional[torch.Tensor] = None   # [L, (h + 2*hk) * dh]
    out_scale: Optional[torch.Tensor] = None   # [L, D]
    ffn1_scale: Optional[torch.Tensor] = None  # [L, 2*I]
    ffn2_scale: Optional[torch.Tensor] = None  # [L, D]

    @property
    def num_layers(self) -> int:
        return self.ln_scale.shape[0]

    @property
    def quantized(self) -> bool:
        return self.qkv_scale is not None

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s six tensors and four scales (None unquantized)."""
        scales = ((self.qkv_scale[i], self.out_scale[i], self.ffn1_scale[i],
                   self.ffn2_scale[i]) if self.quantized else (None,) * 4)
        return (self.ln_scale[i], self.qkv_w[i], self.out_w[i],
                self.ffn_ln_scale[i], self.ffn1_w[i], self.ffn2_w[i]) + scales


def fused_weights_from_llama(model, quantize=False) -> FusedTransformerWeights:
    """Stack a ``LlamaForCausalLM``'s decoder weights into the fused
    layout. ``quantize``: False, True or "int8" (per-channel int8
    weight-only), or "int4" (two values per byte, ``pack_int4``).

    Each stacked tensor is allocated once and filled layer by layer, so the
    peak is the model plus one copy of its decoder weights. Quantized stacks
    are filled layer by layer too (the JAX function stacks the whole decoder
    in the model dtype first); per-column quantization makes the result
    bit-equal either way."""
    layers = model.model.layers
    at, mlp = layers[0].self_attn, layers[0].mlp
    nq, nk = at.q_proj.out_features, at.k_proj.out_features
    D, inter = at.q_proj.in_features, mlp.gate_proj.out_features
    ref = at.q_proj.weight
    int4 = quantize == "int4"
    algo = "weight_only_int4" if int4 else "weight_only_int8"
    L = len(layers)

    def new(*shape, dtype=ref.dtype):
        return torch.empty((L,) + shape, dtype=dtype, device=ref.device)

    def new_w(k, n):
        if not quantize:
            return new(k, n)
        return new(k // 2 if int4 else k, n, dtype=torch.int8)

    w = FusedTransformerWeights(
        ln_scale=new(D), qkv_w=new_w(D, nq + 2 * nk), out_w=new_w(nq, D),
        ffn_ln_scale=new(D), ffn1_w=new_w(D, 2 * inter),
        ffn2_w=new_w(inter, D))
    if quantize:
        f32 = torch.float32
        w.qkv_scale, w.out_scale = new(nq + 2 * nk, dtype=f32), new(D, dtype=f32)
        w.ffn1_scale, w.ffn2_scale = new(2 * inter, dtype=f32), new(D, dtype=f32)
    with torch.no_grad():
        for i, layer in enumerate(layers):
            at, mlp = layer.self_attn, layer.mlp
            w.ln_scale[i].copy_(layer.input_layernorm.weight)
            w.ffn_ln_scale[i].copy_(layer.post_attention_layernorm.weight)
            mats = ((w.qkv_w, w.qkv_scale, (at.q_proj, at.k_proj, at.v_proj)),
                    (w.out_w, w.out_scale, (at.o_proj,)),
                    (w.ffn1_w, w.ffn1_scale, (mlp.gate_proj, mlp.up_proj)),
                    (w.ffn2_w, w.ffn2_scale, (mlp.down_proj,)))
            for stack, scale, projs in mats:
                if not quantize:
                    col = 0
                    for p in projs:
                        n = p.out_features
                        stack[i, :, col:col + n].copy_(p.weight.t())
                        col += n
                    continue
                # the [in, out] matrix in the model dtype, one layer at a time
                q, sc = weight_quantize(
                    torch.cat([p.weight.t() for p in projs], dim=1), algo=algo)
                stack[i].copy_(pack_int4(q) if int4 else q)
                scale[i].copy_(sc)
    return w


def _dequant_matmul(x, w, scale, compute_dtype):
    """``x @ w`` in the compute dtype, or with weight-only int8/int4 ``w``
    and its per-column ``scale``, the weight-only GEMM (int4 is told apart
    by shape: ``[K/2, N]`` packed rows against x's K), as
    ``_maybe_dequant_matmul`` (``fused_transformer.py:79-103``)."""
    if scale is None:
        return x @ w
    lead, K = x.shape[:-1], x.shape[-1]
    fn = int4_weight_matmul if w.shape[-2] * 2 == K else int8_weight_matmul
    y = fn(x.reshape(-1, K), w, scale, out_dtype=compute_dtype)
    return y.reshape(*lead, -1)


def _paged_qkv_rope(h, w, hq, hk, eps, rope_cos, rope_sin):
    """RMS norm -> QKV projection -> head split -> rope on q and k: the
    pre-attention glue every layer body here shares (dense and paged), so
    the paths compute per-layer math identically."""
    b, s = h.shape[0], h.shape[1]
    ln_s, qkv_w, qkv_sc = w[0], w[1], w[6]
    dh = qkv_w.shape[-1] // (hq + 2 * hk)
    qkv = _dequant_matmul(rms_norm_f32(h, ln_s, eps), qkv_w, qkv_sc, h.dtype)
    q = qkv[..., :hq * dh].reshape(b, s, hq, dh)
    k = qkv[..., hq * dh:(hq + hk) * dh].reshape(b, s, hk, dh)
    v = qkv[..., (hq + hk) * dh:].reshape(b, s, hk, dh)
    return _rope(q, rope_cos, rope_sin), _rope(k, rope_cos, rope_sin), v


def _paged_out_ffn(h, attn, w, eps):
    """Output projection -> residual -> RMS norm -> SwiGLU FFN -> residual,
    shared like :func:`_paged_qkv_rope`."""
    b, s = h.shape[0], h.shape[1]
    out_w, ffn_ln_s, ffn1_w, ffn2_w = w[2], w[3], w[4], w[5]
    out_sc, ffn1_sc, ffn2_sc = w[7], w[8], w[9]
    dt = h.dtype
    h = h + _dequant_matmul(attn.reshape(b, s, -1), out_w, out_sc, dt)
    gu = _dequant_matmul(rms_norm_f32(h, ffn_ln_s, eps), ffn1_w, ffn1_sc, dt)
    inter = gu.shape[-1] // 2
    act = swiglu_f32(gu[..., :inter], gu[..., inter:])
    return h + _dequant_matmul(act, ffn2_w, ffn2_sc, dt)


def fused_multi_transformer(x, weights: FusedTransformerWeights, cache_k,
                            cache_v, cache_index: int, rope_cos, rope_sin,
                            num_heads: int, num_kv_heads: int,
                            epsilon: float = 1e-6):
    """One step of ``s`` tokens through all L layers over dense caches.

    x ``[b, s, D]``; cache_k/v ``[L, b, S_max, hk, dh]``; ``cache_index``
    (int) tokens already in the cache; rope_cos/sin ``[s, dh]`` for this
    step's positions. Writes the step's k/v into the caches at
    ``cache_index`` in place and returns ``(h, cache_k, cache_v)``.

    s <= 8: a dense masked attention over the cached columns plus the
    step's own causal block, one joint softmax. s > 8: the flash forward
    over the cache with ``causal=True, q_offset=cache_index`` — row r sees
    column c iff ``c <= cache_index + r``, the JAX ``step_mask`` rule
    without materialising a mask."""
    b, s, _ = x.shape
    hq, hk = num_heads, num_kv_heads
    idx = int(cache_index)
    s_max, dh = cache_k.shape[2], cache_k.shape[-1]
    if idx < 0 or idx + s > s_max:
        raise ValueError(f"fused_multi_transformer: {s} tokens at index "
                         f"{idx} overflow a cache of {s_max}")
    h = x
    if s > 8:
        for i in range(weights.num_layers):
            w = weights.layer(i)
            q, k, v = _paged_qkv_rope(h, w, hq, hk, epsilon, rope_cos,
                                      rope_sin)
            cache_k[i, :, idx:idx + s] = k
            cache_v[i, :, idx:idx + s] = v
            attn = flash_attention(q, cache_k[i], cache_v[i], causal=True,
                                   q_offset=idx)
            h = _paged_out_ffn(h, attn, w, epsilon)
        return h, cache_k, cache_v

    dev, dtype = x.device, x.dtype
    col = torch.arange(s_max, device=dev)
    row = torch.arange(s, device=dev)
    cache_mask = torch.where(col < idx, 0.0, -1e30)[None, None, None]
    self_mask = torch.where(row[None, :] <= row[:, None], 0.0,
                            -1e30)[None, None]
    r = hq // hk
    new_k, new_v = [], []
    for i in range(weights.num_layers):
        w = weights.layer(i)
        q, k, v = _paged_qkv_rope(h, w, hq, hk, epsilon, rope_cos,
                                  rope_sin)
        kk, vv = cache_k[i], cache_v[i]
        kn, vn = k, v
        if r > 1:
            kk, vv, kn, vn = (t.repeat_interleave(r, dim=2)
                              for t in (kk, vv, kn, vn))
        qf = (q.float() / math.sqrt(dh)).to(dtype).float()
        lc = torch.einsum("bqhd,bkhd->bhqk", qf, kk.float()) + cache_mask
        ls = torch.einsum("bqhd,bkhd->bhqk", qf, kn.float()) + self_mask
        probs = torch.softmax(torch.cat([lc, ls], dim=-1), dim=-1)
        pc = probs[..., :s_max].to(dtype).float()
        pn = probs[..., s_max:].to(dtype).float()
        attn = (torch.einsum("bhqk,bkhd->bqhd", pc, vv.float())
                + torch.einsum("bhqk,bkhd->bqhd", pn, vn.float())).to(dtype)
        h = _paged_out_ffn(h, attn, w, epsilon)
        new_k.append(k)
        new_v.append(v)
    # the caches stay read-only inside the loop; one write commits the step
    cache_k[:, :, idx:idx + s] = torch.stack(new_k).to(cache_k.dtype)
    cache_v[:, :, idx:idx + s] = torch.stack(new_v).to(cache_v.dtype)
    return h, cache_k, cache_v


def _paged_decode_layer(h, w, ck, cv, ksc, vsc, *, table, lens, rope_cos,
                        rope_sin, hq, hk, epsilon):
    """One decoder layer of a paged decode step (s == 1): the paged kernel
    over the row's history (int8 pages when ``ksc``/``vsc``, the layer's
    scales, are given), then the exact online-softmax merge of the step's
    own k/v, unquantized, through the kernel's (m, l) stats, so the pages
    stay read-only here. Returns ``(h, (k[:, 0], v[:, 0]))``."""
    dh = ck.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    q, k, v = _paged_qkv_rope(h, w, hq, hk, epsilon, rope_cos, rope_sin)
    q0 = q[:, 0]
    out_old, m, l = paged_attention(q0, ck, cv, table, lens, scale=scale,
                                    return_stats=True, k_scales=ksc,
                                    v_scales=vsc)   # [b, hq, dh], [b, hq]
    kn, vn = k[:, 0], v[:, 0]                            # [b, hk, dh]
    if hk != hq:
        kn = kn.repeat_interleave(hq // hk, dim=1)
        vn = vn.repeat_interleave(hq // hk, dim=1)
    logit_self = (q0.float() * kn.float()).sum(dim=-1) * scale
    m2 = torch.maximum(m, logit_self)
    w_old = l * torch.exp(m - m2)
    w_new = torch.exp(logit_self - m2)
    attn = (w_old[..., None] * out_old.float()
            + w_new[..., None] * vn.float()) / (w_old + w_new)[..., None]
    h = _paged_out_ffn(h, attn[:, None].to(h.dtype), w, epsilon)
    return h, (k[:, 0], v[:, 0])


def contiguous_page_table(batch: int, pps: int, device=None) -> torch.Tensor:
    """The static contiguous page table ``[batch, pps]`` int32: ``table[b]
    = b * pps + arange(pps)`` (``fused_transformer.py:332-335``)."""
    return (torch.arange(batch, dtype=torch.int32, device=device)[:, None]
            * pps + torch.arange(pps, dtype=torch.int32, device=device))


def paged_cache_from_dense(k_dense, v_dense, page_size: int, pps: int):
    """Pack dense caches ``[L, B, S, kvh, dh]`` into page buffers ``[L, kvh,
    B * pps, page, dh]`` of the contiguous layout
    (``fused_transformer.py:309-329``): all S slots verbatim (callers pass
    caches that are zero past the valid prefix, as fresh prefill caches
    are), the pages past them zero. New tensors; the dense ones are left
    as they are."""
    L, B, S, kvh, dh = k_dense.shape
    if S > pps * page_size:
        raise ValueError(f"paged_cache_from_dense: {S} slots do not fit "
                         f"{pps} pages of {page_size}")

    def pack(c):
        full = c.new_zeros((L, kvh, B, pps * page_size, dh))
        full[:, :, :, :S] = c.permute(0, 3, 1, 2, 4)
        return full.view(L, kvh, B * pps, page_size, dh)

    return pack(k_dense), pack(v_dense)


def fused_multi_transformer_paged(x, weights: FusedTransformerWeights,
                                  k_pages, v_pages, cache_index: int,
                                  rope_cos, rope_sin, num_heads: int,
                                  num_kv_heads: int, epsilon: float = 1e-6):
    """One decode step (s == 1) through all L layers over the contiguous
    paged layout (``fused_transformer.py:468-517``): k_pages/v_pages
    ``[L, kvh, B * pps, page, dh]``, every row ``cache_index`` tokens
    long; rope_cos/sin ``[1, dh]``. Each layer is the ragged path's layer
    (the paged kernel with stats over the contiguous table, then the
    exact merge of the step's own k/v), the pages read-only inside the
    loop; after it one write commits the step at slot ``cache_index %
    page`` of page ``cache_index // page`` of every row, in place.
    Returns ``(h, k_pages, v_pages)``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("fused_multi_transformer_paged is decode-only "
                         f"(s == 1), got s={s}")
    L, kvh, n_pages, page, dh = k_pages.shape
    pps = n_pages // b
    idx = int(cache_index)
    if n_pages != b * pps or not 0 <= idx < pps * page:
        raise ValueError(f"fused_multi_transformer_paged: {n_pages} pages "
                         f"for {b} rows, index {idx}: not a contiguous "
                         f"layout with room for the step")
    table = contiguous_page_table(b, pps, device=x.device)
    lens = torch.full((b,), idx, dtype=torch.int32, device=x.device)
    h, ys_k, ys_v = x, [], []
    for i in range(weights.num_layers):
        h, (k, v) = _paged_decode_layer(
            h, weights.layer(i), k_pages[i], v_pages[i], None, None,
            table=table, lens=lens, rope_cos=rope_cos, rope_sin=rope_sin,
            hq=num_heads, hk=num_kv_heads, epsilon=epsilon)
        ys_k.append(k)
        ys_v.append(v)
    for pages, ys in ((k_pages, ys_k), (v_pages, ys_v)):
        rows = pages.view(L, kvh, b, pps, page, dh)
        rows[:, :, :, idx // page, idx % page] = \
            torch.stack(ys).transpose(1, 2).to(pages.dtype)
    return h, k_pages, v_pages


def fused_multi_transformer_paged_ragged(x, weights: FusedTransformerWeights,
                                         k_pages, v_pages, page_table,
                                         seq_lens, rope_cos, rope_sin,
                                         num_heads: int, num_kv_heads: int,
                                         epsilon: float = 1e-6,
                                         k_scales=None, v_scales=None):
    """One decode step (s == 1) through all L layers with per-row block
    tables and lengths (the continuous-batching layer stack).

    k_pages/v_pages ``[L, kvh, num_blocks, page, dh]`` (block 0 is the null
    block); page_table ``[B, pps]`` int32; seq_lens ``[B]`` int32 tokens
    already cached per row (the position the step's token lands at);
    rope_cos/sin ``[B, 1, dh]``. After the layer loop one per-row scatter
    commits the step's k/v in place at ``(table[b, len // page],
    len % page)``; idle rows (all-null table, len 0) write into the null
    block. Returns ``(h, k_pages, v_pages)``.

    Quantized pool (``k_scales``/``v_scales`` ``[L, num_blocks, kvh,
    page]`` f32): the pages are int8, the kernel dequantizes them, and the
    commit quantizes the step's k/v with ``quantize_kv`` and writes value
    and scale at the same (block, slot); returns ``(h, k_pages, v_pages,
    k_scales, v_scales)``."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError("fused_multi_transformer_paged_ragged is decode-only "
                         f"(s == 1), got s={s}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("fused_multi_transformer_paged_ragged: pass both "
                         "k_scales and v_scales or neither")
    quant = k_scales is not None
    page, pps = k_pages.shape[-2], page_table.shape[1]
    table = page_table.to(torch.int32).contiguous()
    lens = seq_lens.to(torch.int32).contiguous()
    h, ys_k, ys_v = x, [], []
    for i in range(weights.num_layers):
        h, (k, v) = _paged_decode_layer(
            h, weights.layer(i), k_pages[i], v_pages[i],
            k_scales[i] if quant else None, v_scales[i] if quant else None,
            table=table, lens=lens, rope_cos=rope_cos, rope_sin=rope_sin,
            hq=num_heads, hk=num_kv_heads, epsilon=epsilon)
        ys_k.append(k)
        ys_v.append(v)
    rows = torch.arange(b, device=x.device)
    phys = table[rows, torch.clamp(lens // page, max=pps - 1)].long()
    slot = (lens % page).long()
    new_k = torch.stack(ys_k).transpose(1, 2)            # [L, kvh, B, dh]
    new_v = torch.stack(ys_v).transpose(1, 2)
    if not quant:
        k_pages[:, :, phys, slot] = new_k.to(k_pages.dtype)
        v_pages[:, :, phys, slot] = new_v.to(v_pages.dtype)
        return h, k_pages, v_pages
    for pages, scales, vals in ((k_pages, k_scales, new_k),
                                (v_pages, v_scales, new_v)):
        qv, sc = quantize_kv(vals)                       # sc [L, kvh, B]
        pages[:, :, phys, slot] = qv
        # block-major scales: the two advanced indices are not adjacent, so
        # the indexed shape is [B, L, kvh]
        scales[:, phys, :, slot] = sc.permute(2, 0, 1)
    return h, k_pages, v_pages, k_scales, v_scales


def _paged_verify_layer(h, w, ck, cv, ksc, vsc, *, table_r, lens_r, strict,
                        rope_cos, rope_sin, hq, hk, epsilon):
    """One decoder layer of a verify step over an ``S``-token window a row:
    the paged kernel over each row's committed history with the window
    folded into its batch (row ``b * S + i``), then the causal in-window
    block merged through the kernel's (m, l) stats. The strictly earlier
    window columns attend through the pool's storage precision (int8
    pages: ``quantize_kv`` then ``dequantize_kv``), the diagonal self
    column raw, as plain decode reads them. Returns ``(h, (k, v))``."""
    b, s = h.shape[0], h.shape[1]
    dh = ck.shape[-1]
    scale = 1.0 / math.sqrt(dh)
    dt = h.dtype
    q, k, v = _paged_qkv_rope(h, w, hq, hk, epsilon, rope_cos, rope_sin)
    out_hist, m, l = paged_attention(
        q.reshape(b * s, hq, dh).contiguous(), ck, cv, table_r, lens_r,
        scale=scale, return_stats=True, k_scales=ksc, v_scales=vsc)
    out_hist = out_hist.reshape(b, s, hq, dh).float().transpose(1, 2)
    m_h = m.reshape(b, s, hq).transpose(1, 2)               # [B, hq, S]
    l_h = l.reshape(b, s, hq).transpose(1, 2)
    if ksc is not None:
        kw_prev = dequantize_kv(*quantize_kv(k), dt)
        vw_prev = dequantize_kv(*quantize_kv(v), dt)
    else:
        kw_prev, vw_prev = k, v
    kw_self, vw_self = k, v
    if hk != hq:
        kw_prev, vw_prev, kw_self, vw_self = (
            t.repeat_interleave(hq // hk, dim=2)
            for t in (kw_prev, vw_prev, kw_self, vw_self))
    qf = q.float()
    lw = torch.einsum("bqhd,bkhd->bhqk", qf, kw_prev.float()) * scale \
        + strict                                             # [B, hq, S, S]
    l_self = (qf * kw_self.float()).sum(dim=-1).transpose(1, 2) * scale
    m2 = torch.maximum(torch.maximum(m_h, l_self), lw.amax(dim=-1))
    w_h = l_h * torch.exp(m_h - m2)
    w_self = torch.exp(l_self - m2)
    p_w = torch.exp(lw - m2[..., None])
    attn = (w_h[..., None] * out_hist
            + w_self[..., None] * vw_self.float().transpose(1, 2)
            + torch.einsum("bhqk,bkhd->bhqd", p_w, vw_prev.float())) \
        / (w_h + w_self + p_w.sum(dim=-1))[..., None]
    h = _paged_out_ffn(h, attn.transpose(1, 2).to(dt), w, epsilon)
    return h, (k, v)


def fused_multi_transformer_paged_ragged_verify(
        x, weights: FusedTransformerWeights, k_pages, v_pages, page_table,
        seq_lens, spans, rope_cos, rope_sin, num_heads: int,
        num_kv_heads: int, epsilon: float = 1e-6, k_scales=None,
        v_scales=None):
    """One speculative-decoding verify step: ``S`` window tokens a row (the
    last committed token and the drafted ones) through all L layers over
    per-row block tables; :func:`fused_multi_transformer_paged_ragged` is
    its ``S == 1`` case.

    x ``[B, S, D]``; page_table ``[B, pps]`` int32; seq_lens ``[B]`` int32
    tokens committed a row (window token ``i`` sits at position ``lens[b]
    + i``); spans ``[B]`` int32, how many window positions commit into the
    pool (the rest go to the null block); rope_cos/sin ``[B, S, dh]``.

    Each window token reads its row's history through the paged kernel
    (``ops/cuda/paged_attention.py``: ``B * S`` rows with the tables and
    lens repeated ``S`` times) and the earlier window tokens through the
    exact (m, l) merge; the pages stay read-only in the layer loop, and
    one masked scatter after it commits ``spans[b]`` positions a row in
    place. A rejected draft is undone by the caller truncating its lens:
    the next window writes those positions again. Returns ``(h, k_pages,
    v_pages)``, with ``k_scales, v_scales`` appended on int8 pages (the
    commit quantizes with ``quantize_kv``, as the ragged decode does)."""
    b, s, _ = x.shape
    if (k_scales is None) != (v_scales is None):
        raise ValueError("fused_multi_transformer_paged_ragged_verify: pass "
                         "both k_scales and v_scales or neither")
    quant = k_scales is not None
    dev = x.device
    page, pps = k_pages.shape[-2], page_table.shape[1]
    table = page_table.to(torch.int32)
    lens = seq_lens.to(torch.int32)
    table_r = table.repeat_interleave(s, dim=0).contiguous()  # [B*S, pps]
    lens_r = lens.repeat_interleave(s, dim=0).contiguous()    # [B*S]
    win = torch.arange(s, device=dev)
    strict = torch.where(win[None, :] < win[:, None], 0.0,
                         -1e30).to(dev)[None, None]            # [1, 1, S, S]
    h, ys_k, ys_v = x, [], []
    for i in range(weights.num_layers):
        h, (k, v) = _paged_verify_layer(
            h, weights.layer(i), k_pages[i], v_pages[i],
            k_scales[i] if quant else None, v_scales[i] if quant else None,
            table_r=table_r, lens_r=lens_r, strict=strict, rope_cos=rope_cos,
            rope_sin=rope_sin, hq=num_heads, hk=num_kv_heads,
            epsilon=epsilon)
        ys_k.append(k)
        ys_v.append(v)
    # commit: positions past a row's span go to the null block; the engine
    # caps spans so that a committed position never passes the last block
    lens_l = lens.long()
    pos = lens_l[:, None] + win[None, :]                       # [B, S]
    valid = win[None, :] < spans.to(dev).long()[:, None]
    rows = torch.arange(b, device=dev)[:, None]
    phys = torch.where(
        valid, table[rows, torch.clamp(pos // page, max=pps - 1)].long(), 0)
    slot = pos % page
    new_k = torch.stack(ys_k).permute(0, 3, 1, 2, 4)        # [L, kvh, B, S, dh]
    new_v = torch.stack(ys_v).permute(0, 3, 1, 2, 4)
    if not quant:
        k_pages[:, :, phys, slot] = new_k.to(k_pages.dtype)
        v_pages[:, :, phys, slot] = new_v.to(v_pages.dtype)
        return h, k_pages, v_pages
    for pages, scales, vals in ((k_pages, k_scales, new_k),
                                (v_pages, v_scales, new_v)):
        qv, sc = quantize_kv(vals)                       # sc [L, kvh, B, S]
        pages[:, :, phys, slot] = qv
        # the indexed shape of the block-major scales is [B, S, L, kvh]
        scales[:, phys, :, slot] = sc.permute(2, 3, 0, 1)
    return h, k_pages, v_pages, k_scales, v_scales
