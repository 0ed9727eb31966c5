"""Paged decode attention: the plain PyTorch version and the wrapper of the
hand-written kernel (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``paddle_tpu/ops/pallas/paged_attention.py``
``paged_attention_pallas`` (``pl.pallas_call`` at :580 with stats, :561
without), over bf16 pages and, with ``k_scales``/``v_scales``, over int8
pages (the Pallas ``_kernel_quant*`` variants). Bounded on the H100 by the
device-memory bytes of the K/V rows it reads (plus 8 bytes of scales per
token and kv head on int8 pages); the kernel reads each valid row once and
never touches a page past a row's length. One launch a call over a fixed
grid (``ptt_paged_grid``) that shares 32-token units out evenly; the rows
split across CTAs are merged in the same launch through an f32 scratch of
two partials a CTA and a counter per (row, kv head), both kept per
(device, stream): every launch leaves the counters at 0. CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ...models.kv_cache import dequantize_kv
from . import _build

__all__ = ["paged_attention", "paged_attention_reference", "NEG_INF",
           "launches", "int8_launches"]

NEG_INF = -1e30

#: kernel launches over bf16 pages since the count was last set to 0
launches = 0
#: kernel launches over int8 pages since the count was last set to 0
int8_launches = 0

#: pages hold a multiple of this many tokens (the kernel's half unit)
TOKENS = 16

_c_int, _ptr = ctypes.c_int, ctypes.c_void_p
_GRID = {}                 # device index -> the kernel's grid
_SCRATCH = {}              # (device, stream) -> (partials, counters)


def paged_attention_reference(q, k_pages, v_pages, page_table, seq_lens,
                              scale: Optional[float] = None,
                              return_stats: bool = False, k_scales=None,
                              v_scales=None):
    """Gather the pages, mask, softmax, in f32. q ``[B, H, D]``; k/v pages
    ``[KVH, P, page, D]``; page_table ``[B, PPS]``; seq_lens ``[B]``.
    Returns out ``[B, H, D]`` in q's dtype and, with ``return_stats``,
    ``(m, l)`` ``[B, H]`` f32: m the masked row max (``NEG_INF`` for an
    empty row), l = Σ exp(s − m) over the valid columns.

    With ``k_scales``/``v_scales`` ``[P, KVH, page]`` f32 the pages are int8
    and only the gathered slice is dequantized, with ``dequantize_kv``, as
    the JAX ``paged_attention_reference`` does (:96-104)."""
    b, h, d = q.shape
    kvh, _, page, _ = k_pages.shape
    pps = page_table.shape[1]
    group = h // kvh
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    table = page_table.long()
    k = k_pages[:, table].transpose(0, 1).reshape(b, kvh, pps * page, d)
    v = v_pages[:, table].transpose(0, 1).reshape(b, kvh, pps * page, d)
    if k_scales is not None:
        # [B, PPS, KVH, page] -> [B, KVH, PPS * page]
        ks = k_scales[table].transpose(1, 2).reshape(b, kvh, pps * page)
        vs = v_scales[table].transpose(1, 2).reshape(b, kvh, pps * page)
        k, v = dequantize_kv(k, ks), dequantize_kv(v, vs)
    qg = q.reshape(b, kvh, group, d).float()
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k.float()) * scale
    pos = torch.arange(pps * page, device=q.device)
    mask = (pos[None, :] < seq_lens.long()[:, None])[:, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    ps = torch.where(mask, torch.exp(scores - m[..., None]),
                     torch.zeros_like(scores))
    l = ps.sum(dim=-1)
    acc = torch.einsum("bkgs,bksd->bkgd", ps, v.float())
    out = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, h, d).to(q.dtype)
    if not return_stats:
        return out
    return out, m.reshape(b, h), l.reshape(b, h)


def _lib():
    lib = _build.load("paged_attention")
    if lib.ptt_paged_decode.argtypes is None:
        lib.ptt_paged_decode.argtypes = [_ptr] * 10 + [_c_int] * 8 \
            + [ctypes.c_float, _ptr]
        lib.ptt_paged_decode.restype = _c_int
        lib.ptt_paged_decode_int8.argtypes = [_ptr] * 12 + [_c_int] * 8 \
            + [ctypes.c_float, _ptr]
        lib.ptt_paged_decode_int8.restype = _c_int
        lib.ptt_paged_grid.argtypes = [_c_int]
    return lib


def _scratch(q, stream: int, floats: int, counters: int):
    """The partials (at least ``floats`` f32) and the counters (at least
    ``counters`` int32, all 0) of ``q``'s device and ``stream``: one pair
    per stream, grown when a call needs more. Launches on one stream run in
    order, and each leaves every counter at 0."""
    key = (q.get_device(), stream)
    part, cnt = _SCRATCH.get(key, (None, None))
    if part is None or part.numel() < floats:
        part = torch.empty(floats, dtype=torch.float32, device=q.device)
    if cnt is None or cnt.numel() < counters:
        cnt = torch.zeros(max(counters, 256), dtype=torch.int32,
                          device=q.device)
    _SCRATCH[key] = (part, cnt)
    return part, cnt


def paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                    scale: Optional[float] = None,
                    return_stats: bool = False, k_scales=None,
                    v_scales=None):
    """Decode attention over paged K/V: the kernel on CUDA tensors (bf16 q,
    bf16 pages or int8 pages with f32 ``k_scales``/``v_scales``
    ``[P, KVH, page]``, int32 table and lens, all contiguous; pages of a
    multiple of 16 tokens), the plain version on CPU tensors. Same contract
    as :func:`paged_attention_reference`."""
    global launches, int8_launches
    what = "paged_attention"
    if (k_scales is None) != (v_scales is None):
        raise ValueError("paged_attention: pass both k_scales and v_scales "
                         "for int8 pages, or neither")
    if _build.device_of(what, q, k_pages, v_pages, page_table, seq_lens,
                        k_scales, v_scales) == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, page_table,
                                         seq_lens, scale, return_stats,
                                         k_scales, v_scales)
    b, h, d = q.shape
    if k_pages.dim() != 4 or k_pages.shape != v_pages.shape \
            or k_pages.shape[3] != d:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} "
                         f"disagree")
    kvh, num_pages, page, _ = k_pages.shape
    if h % kvh or h // kvh not in (1, 2, 4, 8) or d not in (64, 128) \
            or page % TOKENS:
        raise ValueError(f"paged_attention: needs group h/kvh in "
                         f"(1, 2, 4, 8), d in (64, 128) and pages of a "
                         f"multiple of {TOKENS} tokens, got h={h} kvh={kvh} "
                         f"d={d} page={page}")
    if page_table.dim() != 2 or page_table.shape[0] != b \
            or seq_lens.shape != (b,):
        raise ValueError(f"paged_attention: page_table "
                         f"{tuple(page_table.shape)} / seq_lens "
                         f"{tuple(seq_lens.shape)} do not match batch {b}")
    quant = k_scales is not None
    page_dtype = torch.int8 if quant else torch.bfloat16
    checks = [("q", q, torch.bfloat16), ("k_pages", k_pages, page_dtype),
              ("v_pages", v_pages, page_dtype),
              ("page_table", page_table, torch.int32),
              ("seq_lens", seq_lens, torch.int32)]
    if quant:
        if k_scales.shape != (num_pages, kvh, page) \
                or v_scales.shape != k_scales.shape:
            raise ValueError(f"paged_attention: scales "
                             f"{tuple(k_scales.shape)}/"
                             f"{tuple(v_scales.shape)} must be "
                             f"{(num_pages, kvh, page)}")
        checks += [("k_scales", k_scales, torch.float32),
                   ("v_scales", v_scales, torch.float32)]
    for name, t, dtype in checks:
        if t.dtype != dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a contiguous "
                             f"{dtype} tensor on {q.device}, got {t.dtype} "
                             f"on {t.device}")
    lib = _lib()
    if b > lib.ptt_paged_max_rows():
        raise ValueError(f"paged_attention: the kernel takes at most "
                         f"{lib.ptt_paged_max_rows()} rows, got {b}")
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    dev = q.get_device()
    grid = _GRID.get(dev)
    if grid is None:
        grid = _GRID[dev] = lib.ptt_paged_grid(dev)
        if grid <= 0:
            raise RuntimeError(f"paged_attention: no grid for device {dev}")
    stream = _build.stream(q)
    part, counters = _scratch(q, stream, 2 * grid * (h // kvh) * (d + 4),
                              b * kvh)
    out = torch.empty_like(q)
    m = l = None
    if return_stats:
        f32 = dict(device=q.device, dtype=torch.float32)
        m, l = torch.empty((b, h), **f32), torch.empty((b, h), **f32)
    pages = (k_pages.data_ptr(), v_pages.data_ptr())
    rest = (page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            m.data_ptr() if return_stats else None,
            l.data_ptr() if return_stats else None, part.data_ptr(),
            counters.data_ptr(), grid, b, h, kvh, num_pages, page,
            page_table.shape[1], d, scale, stream)
    if quant:
        rc = lib.ptt_paged_decode_int8(q.data_ptr(), *pages,
                                       k_scales.data_ptr(),
                                       v_scales.data_ptr(), *rest)
        _build.check(lib, rc, "paged_attention (int8 pages)")
        int8_launches += 1
    else:
        rc = lib.ptt_paged_decode(q.data_ptr(), *pages, *rest)
        _build.check(lib, rc, "paged_attention")
        launches += 1
    return (out, m, l) if return_stats else out
