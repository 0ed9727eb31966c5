"""Paged-KV serving attention, Paddle's ``block_multihead_attention`` and
``masked_multihead_attention`` (the counterpart of
``paddle_tpu/ops/fused/block_attention.py``).

:class:`PagedKVCache` owns a page pool ``[kv_heads, num_pages, page_size,
head_dim]`` (the layout of the paged kernel, ``ops/cuda/paged_attention``),
a page table ``[batch, pages_per_seq]`` int32 and the lengths ``[batch]``
int32 on the device, with host mirrors of both: page 0 is the null page of
unallocated slots, and the host allocates pages every step without reading
the device. :func:`block_multihead_attention` writes a step's k and v into
the pages and attends over the paged history: one query row a sequence
(T = 1) through the paged kernel (its plain version on CPU tensors; on
CUDA tensors the kernel or an error: bf16 pages of a multiple of 16
tokens, 1, 2, 4 or 8 query heads a kv head), more rows (a prefill)
through a causal attention over the gathered pages in f32 torch ops, as
the JAX function does with jnp. :func:`masked_multihead_attention` is the
dense-cache decode step, plain torch ops as in JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core.device import resolve_device
from ...core.dtype import to_torch_dtype
from ..cuda.paged_attention import paged_attention

__all__ = ["PagedKVCache", "block_multihead_attention",
           "masked_multihead_attention"]


class PagedKVCache:
    """Page pool and per-sequence page tables (Paddle's block tables).

    ``k_pages``/``v_pages`` ``[kv_heads, num_pages, page_size, head_dim]``,
    ``page_table [batch, pages_per_seq]`` int32 (the physical page of each
    logical page), ``seq_lens [batch]`` int32, on ``device`` (default
    ``cuda``). Page 0 is reserved as the null page."""

    def __init__(self, batch, kv_heads, head_dim, max_seq_len, page_size=16,
                 num_pages=None, dtype=torch.bfloat16, device=None):
        dev = resolve_device(device)
        self.page_size = page_size
        self.pages_per_seq = (max_seq_len + page_size - 1) // page_size
        if num_pages is None:
            num_pages = 1 + batch * self.pages_per_seq  # page 0 = null
        self.k_pages = torch.zeros((kv_heads, num_pages, page_size, head_dim),
                                   dtype=to_torch_dtype(dtype), device=dev)
        self.v_pages = torch.zeros_like(self.k_pages)
        self.page_table = torch.zeros((batch, self.pages_per_seq),
                                      dtype=torch.int32, device=dev)
        self.seq_lens = torch.zeros((batch,), dtype=torch.int32, device=dev)
        # host mirrors: the allocator runs every decode step and must not
        # read the device
        self._host_table = np.zeros((batch, self.pages_per_seq), np.int32)
        self._host_lens = [0] * batch
        self._free_pages = list(range(num_pages - 1, 0, -1))
        self.batch = batch

    def _pages_needed(self, batch_idx: int, n_tokens: int):
        cur = self._host_lens[batch_idx]
        need = (cur + n_tokens + self.page_size - 1) // self.page_size
        have = (cur + self.page_size - 1) // self.page_size
        return list(range(have, need))

    def allocate(self, batch_idx: int, n_tokens: int):
        """Room for ``n_tokens`` more tokens of sequence ``batch_idx``
        (checked before anything changes)."""
        self.allocate_batch({batch_idx: n_tokens})

    def allocate_batch(self, requests):
        """All or nothing for several rows (``{row: n_tokens}``): either
        every row gets its pages or nothing changes."""
        plan = {bi: self._pages_needed(bi, n) for bi, n in requests.items()}
        total = sum(len(lps) for lps in plan.values())
        if total > len(self._free_pages):
            raise RuntimeError(
                f"paged KV cache: page pool exhausted "
                f"(need {total}, free {len(self._free_pages)})")
        if not total:
            return
        for bi, lps in plan.items():
            for lp in lps:
                self._host_table[bi, lp] = self._free_pages.pop()
        self.page_table.copy_(torch.from_numpy(self._host_table))

    def free(self, batch_idx: int):
        """Release a finished sequence: its pages return to the free list
        and its table row to the null page."""
        row = self._host_table[batch_idx]
        self._free_pages.extend(int(p) for p in row[row > 0])
        self._host_table[batch_idx] = 0
        self.page_table[batch_idx] = 0
        self.seq_lens[batch_idx] = 0
        self._host_lens[batch_idx] = 0


def _prefill_attention(q, cache, lens, scale):
    """Causal attention of ``q [b, t, h, d]`` (rows at positions ``lens[i]
    + 0 .. t - 1``) over every gathered page, in f32."""
    b, t, h, d = q.shape
    kvh, page = cache.k_pages.shape[0], cache.page_size
    S = cache.pages_per_seq * page
    table = cache.page_table.long()
    kk = cache.k_pages[:, table].transpose(0, 1).reshape(b, kvh, S, d)
    vv = cache.v_pages[:, table].transpose(0, 1).reshape(b, kvh, S, d)
    group = h // kvh
    qg = q.transpose(1, 2).reshape(b, kvh, group, t, d).float()
    s = torch.einsum("bkgtd,bksd->bkgts", qg, kk.float()) * scale
    spos = torch.arange(S, device=q.device)[None, None, :]
    qpos = lens.long()[:, None, None] \
        + torch.arange(t, device=q.device)[None, :, None]
    s = s.masked_fill(~(spos <= qpos)[:, None, None], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgts,bksd->bkgtd", p, vv.float())
    return out.reshape(b, h, t, d).transpose(1, 2).to(q.dtype)


def block_multihead_attention(q, k, v, cache: PagedKVCache, scale=None):
    """Append ``k``/``v [B, T, KVH, D]`` to the paged cache and attend ``q
    [B, T, H, D]`` over each sequence's whole paged history. Returns
    ``(out [B, T, H, D], cache)``. T = 1 runs the paged kernel; T > 1
    attends causally over the gathered pages."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    page = cache.page_size
    cache.allocate_batch({bi: t for bi in range(b)})  # all or nothing
    # where each new token goes, from the host mirrors
    pos = np.asarray(cache._host_lens, np.int64)[:, None] + np.arange(t)
    phys = cache._host_table[np.arange(b)[:, None], pos // page].reshape(-1)
    dev = cache.k_pages.device
    phys_t = torch.from_numpy(phys.astype(np.int64)).to(dev)
    slot_t = torch.from_numpy((pos % page).reshape(-1)).to(dev)
    cache.k_pages[:, phys_t, slot_t] = k.reshape(b * t, kvh, d) \
        .transpose(0, 1).to(cache.k_pages.dtype)
    cache.v_pages[:, phys_t, slot_t] = v.reshape(b * t, kvh, d) \
        .transpose(0, 1).to(cache.v_pages.dtype)
    new_lens = cache.seq_lens + t
    if t == 1:
        out = paged_attention(q.reshape(b, h, d), cache.k_pages,
                              cache.v_pages, cache.page_table, new_lens,
                              scale=scale).reshape(b, 1, h, d)
    else:
        sc = 1.0 / math.sqrt(d) if scale is None else float(scale)
        out = _prefill_attention(q, cache, cache.seq_lens, sc)
    cache.seq_lens = new_lens
    cache._host_lens = [n + t for n in cache._host_lens]
    return out, cache


def masked_multihead_attention(x, cache_k, cache_v, seq_lens=None,
                               scale=None):
    """Dense-cache decode (Paddle's ``masked_multihead_attention``): ``x``
    is the step's fused qkv ``[B, 3 * H * D]`` (q is its first third) or q
    ``[B, H, D]``; ``cache_k``/``cache_v [B, H, S, D]`` already hold the
    new position. The one query attends positions ``< seq_lens`` (all S
    without it), in f32. Returns ``[B, H, D]`` in q's dtype."""
    b, h, s, d = cache_k.shape
    q = x.reshape(b, 3, h, d)[:, 0] if x.dim() == 2 else x
    sc = 1.0 / math.sqrt(d) if scale is None else float(scale)
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), cache_k.float()) * sc
    if seq_lens is not None:
        seen = torch.arange(s, device=q.device)[None, None, :] \
            < seq_lens.to(q.device)[:, None, None]
        scores = scores.masked_fill(~seen, -1e30)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bhsd->bhd", p, cache_v.float()).to(q.dtype)
