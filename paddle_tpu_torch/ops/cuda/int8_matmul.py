"""Weight-only int8 and int4 GEMMs: int4 packing, the plain PyTorch versions
and the wrappers of the hand-written kernels (``csrc/int8_matmul.cu``).

Replace the TPU kernels ``paddle_tpu/ops/pallas/int8_matmul.py``
``int8_weight_matmul`` (``pl.pallas_call`` at :143) and
``int4_weight_matmul`` (:197). ``x [m, K]`` (cast to bf16, as the JAX
functions do) times an int8 ``[K, N]`` or half-split packed int4 ``[K/2, N]``
weight, f32 accumulation, times the per-column f32 scale, cast to the output
dtype. Bounded on the H100 by the weight bytes at decode shapes and by
operations at the 256-row prefill bucket; the kernels read the weight at
int8 (int4) width and dequantize it on the chip: in registers at decode
(``m <= 64``), into a swizzled bf16 tile for wgmma above.

One launch per product. :func:`plan` cuts the product into (column tile,
k step) units and splits them evenly over a grid sized from the SM count;
tiles that several CTAs share are summed inside the launch, in a fixed
order, in a thread block cluster's shared memory or through a per-stream
f32 scratch and per-tile counters (:func:`cta_units`,
:func:`contributors`, :func:`slot`). The plan is cached
per (device, m, K, N, kind). The weight's tensor map is encoded once per
weight tensor, x's (the wgmma kernel's) once per (device, m, K): each
launch points its CTAs' copies at its own x on the device.

The dispatch rule is the JAX package's (``int8_matmul.py:116-121``, :134,
:186): the kernel takes a product when ``m <= 256``, ``K % 128 == 0`` (int4:
``(K / 2) % 128 == 0``) and ``N % 128 == 0``. Other shapes are computed as
the JAX package computes them outside Pallas: the weight dequantized to
bf16 (exact), a product with f32 accumulation, the scale, the cast. On CUDA
tensors a shape that passes the rule launches the kernel or raises; CPU
tensors take the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["pack_int4", "unpack_int4_packed", "int8_weight_matmul",
           "int4_weight_matmul", "int8_weight_matmul_reference",
           "int4_weight_matmul_reference", "kernel_takes", "launches",
           "int4_launches", "Plan", "plan", "decode_plan", "wgmma_plan",
           "cta_units", "contributors", "slot", "decode_fragment_model"]

#: int8 kernel launches since the count was last set to 0
launches = 0
#: int4 kernel launches since the count was last set to 0
int4_launches = 0

MAX_ROWS = 256           # the JAX kernel's m limit
DECODE_MAX_ROWS = 64     # the decode kernel's rows; above, the wgmma kernel
DECODE_OCC = 2           # its CTAs per SM at most (csrc: D_OCC)
ALIGNED_MIN = 0.7        # see decode_plan()
WROWS = 64               # weight rows of a decode k step (int4: packed rows)
_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_SMS: Dict[int, int] = {}
_PLANS: Dict[tuple, "Plan"] = {}                 # (device, m, K, N, int4)
_SCRATCH: Dict[tuple, tuple] = {}     # (device, stream) -> (ws, flags)
_MAPS: Dict[tuple, ctypes.Array] = {}  # (w pointer, rows, N, box rows)
_XMAPS: Dict[tuple, ctypes.Array] = {}  # (device, m, K)
_CALLS: Dict[tuple, tuple] = {}       # see _launch()
_ENTRY = None                         # see _entry()


class Plan(NamedTuple):
    """The grid of one product: ``kind`` 0 (decode kernel) or 1 (wgmma
    kernel), ``bn`` columns a tile, ``rows`` of x the kernel holds (a scratch
    slot is ``rows x bn`` floats), ``steps`` k steps a tile of ``wrows``
    weight rows each (the TMA box's rows), ``tiles``, ``ctas`` (the grid)
    and ``cluster``: CTAs a thread block cluster along K (1: none; else
    exactly one tile's contributors, whose sums meet in distributed shared
    memory instead of the scratch)."""
    kind: int
    bn: int
    rows: int
    steps: int
    wrows: int
    tiles: int
    ctas: int
    cluster: int = 1

    @property
    def units(self) -> int:
        return self.tiles * self.steps

    @property
    def ws_floats(self) -> int:
        """f32 scratch the launch needs: two slots a CTA, and for the wgmma
        kernel 128 bytes a CTA for its copy of x's tensor map."""
        return 2 * self.ctas * self.rows * self.bn \
            + (32 * self.ctas if self.kind else 0)


def decode_plan(m: int, K: int, N: int, int4: bool, sms: int, bn: int,
                occ: int, clusters=None) -> Plan:
    """The decode kernel's grid for ``x [m, K]`` (m <= 64) times a ``[K,
    N]`` weight on a card of ``sms`` SMs, ``occ`` CTAs an SM: ``bn``
    columns (the kernel's tile, ``ptt_weight_only_decode_bn``) and 64
    weight rows (int4: 128 k) a unit, 8, 16, 32 or 64 rows (the kernel's
    8-row tiles, a power of two). One CTA per unit up to ``sms x occ``
    (stream-K), or the largest smaller grid whose shares are equal and
    divide a tile's steps (or are whole tiles) when it keeps
    ``ALIGNED_MIN`` of the CTAs: its CTAs then stream the same weight rows
    at the same time, which the card's memory serves faster than rows at
    132 different depths (Llama-3-8B ``out`` at m = 8 on an H100: 0.0185 ms
    against 0.0213). A tile that k-aligned shares split into n <= 8 is one
    cluster of n CTAs when ``clusters(n)`` (how many such clusters the card
    holds at once; None: enough) covers the grid in one wave: their sums
    meet in distributed shared memory, faster than the fix-up through L2
    (``out`` at m = 8: 0.0173 ms against 0.0188)."""
    rows = next(r for r in (8, 16, 32, 64) if m <= r)   # 8 MT
    steps = (K // 2 if int4 else K) // WROWS
    tiles = N // bn
    units = tiles * steps
    ctas = min(units, sms * occ)
    aligned = max(c for c in range(1, ctas + 1) if units % c == 0 and (
        steps % (units // c) == 0 or (units // c) % steps == 0))
    cluster = 1
    if aligned >= ALIGNED_MIN * ctas:
        ctas = aligned
        n = steps * ctas // units            # shares a tile
        if 1 < n <= 8 and (clusters is None or clusters(n) * n >= ctas):
            cluster = n
    return Plan(0, bn, rows, steps, WROWS, tiles, ctas, cluster)


def wgmma_plan(m: int, K: int, N: int, int4: bool, sms: int) -> Plan:
    """The wgmma kernel's grid: 128 columns (256 when ``m <= 128`` and 256
    divides N) and 64 k a unit, ``128 ceil(m / 128)`` rows, one CTA an SM
    up to one per unit (stream-K)."""
    bn = 256 if m <= 128 and N % 256 == 0 else 128
    wrows = 32 if int4 else 64
    steps = (K // 2 if int4 else K) // wrows
    tiles = N // bn
    return Plan(1, bn, 128 * -(-m // 128), steps, wrows, tiles,
                min(tiles * steps, sms))


def plan(m: int, K: int, N: int, int4: bool, sms: int, bn: int,
         occ: int, clusters=None) -> Plan:
    """The grid the kernels take for ``x [m, K]`` times a ``[K, N]`` weight:
    :func:`decode_plan` for ``m <= DECODE_MAX_ROWS`` (``bn``, ``occ``,
    ``clusters``: the decode kernel's column tile, CTAs an SM and resident
    clusters, all read from the library), else :func:`wgmma_plan`."""
    if m <= DECODE_MAX_ROWS:
        return decode_plan(m, K, N, int4, sms, bn, occ, clusters)
    return wgmma_plan(m, K, N, int4, sms)


def cta_units(p: Plan, c: int) -> range:
    """The units of CTA ``c`` (tile-major: ``u = tile * steps + step``), as
    the kernels compute them: ``[floor(c U / P), floor((c + 1) U / P))``."""
    return range(c * p.units // p.ctas, (c + 1) * p.units // p.ctas)


def contributors(p: Plan, tile: int) -> range:
    """The CTAs whose units meet ``tile``, in the order their sums are
    added: the kernels' ``cta_of`` of the tile's first and last unit."""
    t0, U, P = tile * p.steps, p.units, p.ctas
    return range(((t0 + 1) * P - 1) // U, ((t0 + p.steps) * P - 1) // U + 1)


def slot(p: Plan, c: int, tile: int) -> int:
    """The scratch slot CTA ``c`` writes its sums of a shared ``tile`` to:
    ``2 c`` for the tile its units start in, ``2 c + 1`` for a later one."""
    return 2 * c + (0 if c * p.units // p.ctas >= tile * p.steps else 1)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 values in [-7, 7] -> ``[K/2, N]`` int8, half-split:
    ``packed[r] = (q[r + K/2] << 4) | (q[r] & 0xF)``."""
    K = q.shape[0]
    if K % 2:
        raise ValueError(f"pack_int4: K = {K} must be even")
    lo = q[:K // 2].to(torch.int32) & 15
    hi = q[K // 2:].to(torch.int32) & 15
    packed = (hi << 4) | lo
    return torch.where(packed > 127, packed - 256, packed).to(torch.int8)


def unpack_int4_packed(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: ``[K/2, N]`` -> ``[K, N]`` int8, each
    nibble sign-extended (low ``((b & 15) ^ 8) - 8``, high ``b >> 4``)."""
    w32 = packed.to(torch.int32)
    lo = ((w32 & 15) ^ 8) - 8
    hi = w32 >> 4
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def kernel_takes(m: int, K: int, N: int, int4: bool) -> bool:
    """The JAX dispatch rule: does the kernel take this product?"""
    k_ok = (K // 2) % 128 == 0 if int4 else K % 128 == 0
    return 1 <= m <= MAX_ROWS and k_ok and N % 128 == 0


def _dot_f32(x: torch.Tensor, w_bf16: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 with f32 accumulation and an f32 result. On the CPU the
    operands are widened (bf16 -> f32 is exact, so the products are the
    same); on CUDA one bf16 product with an f32 output."""
    xb = x.to(torch.bfloat16)
    if x.device.type == "cpu":
        return xb.float() @ w_bf16.float()
    return torch.mm(xb, w_bf16, out_dtype=torch.float32)


def int8_weight_matmul_reference(x, w_q, scale, out_dtype=None):
    """The plain version: ``(bf16(x) @ bf16(w_q)) * scale`` with f32
    accumulation, cast to ``out_dtype`` (default ``x.dtype``)."""
    y = _dot_f32(x, w_q.to(torch.bfloat16))
    return (y * scale.float()[None, :]).to(out_dtype or x.dtype)


def int4_weight_matmul_reference(x, w_packed, scale, out_dtype=None):
    """The plain version of the int4 product: unpack, then as
    :func:`int8_weight_matmul_reference`."""
    return int8_weight_matmul_reference(x, unpack_int4_packed(w_packed),
                                        scale, out_dtype)


def _entry():
    """The C entry ``ptt_weight_only_gemm`` with its argument types set,
    looked up once."""
    global _ENTRY
    if _ENTRY is None:
        fn = _build.load("int8_matmul").ptt_weight_only_gemm
        fn.argtypes = [_ptr] * 8 + [_c_int] * 8 + [_ptr]
        fn.restype = _c_int
        _ENTRY = fn
    return _ENTRY


def _plan(m: int, K: int, N: int, int4: bool, idx: int) -> Plan:
    """:func:`plan` for device ``idx``, computed once per shape: the SM
    count from the device, the decode kernel's column tile, CTAs an SM and
    resident clusters (registers and shared memory both count) from the
    library."""
    key = (idx, m, K, N, int4)
    got = _PLANS.get(key)
    if got is None:
        if idx not in _SMS:
            _SMS[idx] = \
                torch.cuda.get_device_properties(idx).multi_processor_count
        lib = _build.load("int8_matmul")

        def resident(n: int) -> int:
            """CTAs an SM (n = 1) or clusters of n the card holds at
            once of the decode kernel for m rows."""
            fn = lib.ptt_weight_only_decode_occupancy
            fn.argtypes = [_c_int] * 3 + [ctypes.POINTER(_c_int)]
            count = _c_int(0)
            with torch.cuda.device(idx):
                _build.check(lib, fn(m, int4, n, ctypes.byref(count)),
                             "weight-only plan")
            return count.value

        occ = min(DECODE_OCC, resident(1)) if m <= DECODE_MAX_ROWS else 1
        got = _PLANS[key] = plan(m, K, N, int4, _SMS[idx],
                                 lib.ptt_weight_only_decode_bn(), occ,
                                 resident)
    return got


def _scratch(idx: int, stream: int, p: Plan) -> tuple:
    """The f32 scratch (at least ``p.ws_floats``) and the tile counters (at
    least ``p.tiles``, all 0) of device ``idx`` and ``stream``: one pair
    per stream, grown when a larger product needs it. Launches on one
    stream run in order, and each leaves every counter at 0."""
    key = (idx, stream)
    got = _SCRATCH.get(key)
    need = p.ws_floats
    if got is not None and got[0].numel() >= need \
            and got[1].numel() >= p.tiles:
        return got
    dev = torch.device("cuda", idx)
    ws, flags = got or (None, None)
    if ws is None or ws.numel() < need:
        ws = torch.empty(need, dtype=torch.float32, device=dev)
    if flags is None or flags.numel() < p.tiles:
        flags = torch.zeros(max(p.tiles, 256), dtype=torch.int32, device=dev)
    got = _SCRATCH[key] = (ws, flags)
    return got


def _weight_map(pw: int, rows: int, N: int, box_rows: int, what: str):
    """The TMA map of the weight at ``pw`` (``[rows, N]`` bytes) in boxes of
    ``box_rows`` rows, encoded once per weight tensor: a weight does not
    move, and the map holds only its address, shape and strides, so the
    key is exactly what it encodes."""
    key = (pw, rows, N, box_rows)
    got = _MAPS.get(key)
    if got is None:
        lib = _build.load("int8_matmul")
        fn = lib.ptt_weight_only_encode
        fn.argtypes = [_ptr, _ptr, _c_int, _c_int, _c_int]
        got = ctypes.create_string_buffer(128)
        _build.check(lib, fn(got, pw, rows, N, box_rows), what)
        _MAPS[key] = got
    return got


def _x_map(idx: int, px: int, m: int, K: int, what: str):
    """The wgmma kernel's tensor map of an ``x [m, K]`` on device ``idx``,
    encoded once per shape with the first x's address: every launch points
    its CTAs' copies at its own x on the device."""
    key = (idx, m, K)
    got = _XMAPS.get(key)
    if got is None:
        lib = _build.load("int8_matmul")
        fn = lib.ptt_weight_only_encode_x
        fn.argtypes = [_ptr, _ptr, _c_int, _c_int]
        got = ctypes.create_string_buffer(128)
        _build.check(lib, fn(got, px, m, K), what)
        _XMAPS[key] = got
    return got


def _prepare(x, w, pw: int, int4: bool, f32: bool, stream: int, what: str):
    """The launch arguments that stay the same from call to call of one
    weight, row count, stream and output type: the weight's map (by
    address), x's map (its shape's), the scratch, the plan; with the
    buffers they point into, which the entry keeps alive."""
    m, K = x.shape
    N = w.shape[1]
    idx = x.get_device()
    p = _plan(m, K, N, int4, idx)
    wmap = _weight_map(pw, w.shape[0], N, p.wrows, what)
    xmap = _x_map(idx, x.data_ptr(), m, K, what) if p.kind else None
    ws, flags = _scratch(idx, stream, p)
    return (ctypes.addressof(wmap), xmap and ctypes.addressof(xmap),
            ws.data_ptr(), flags.data_ptr(), p.kind, p.ctas, p.cluster,
            int(f32), (wmap, xmap, ws, flags))


def _launch(x, w, scale, out_dtype, int4: bool, what: str):
    # called 4 x L times per decode step: each check is the cheapest that
    # tells (dtypes are singletons; no copy when x and scale are in order),
    # and one lookup gives what stays the same from call to call
    m, K = x.shape
    N = w.shape[1]
    if out_dtype is not torch.bfloat16 and out_dtype is not torch.float32:
        raise ValueError(f"{what}: the kernel writes bf16 or f32, not "
                         f"{out_dtype}")
    if x.dtype is not torch.bfloat16:
        x = x.to(torch.bfloat16)
    if not x.is_contiguous():
        x = x.contiguous()
    if scale.dtype is not torch.float32 or not scale.is_contiguous():
        scale = scale.to(torch.float32).contiguous()
    idx = x.get_device()
    if w.dtype is not torch.int8 or not w.is_contiguous() \
            or w.get_device() != idx or scale.get_device() != idx:
        raise ValueError(f"{what}: w must be a contiguous int8 tensor and "
                         f"scale a tensor on {x.device}, got w {w.dtype} on "
                         f"{w.device}, scale on {scale.device}")
    px, pw, ps = x.data_ptr(), w.data_ptr(), scale.data_ptr()
    if (px | pw | ps) % 16:
        raise ValueError(f"{what}: x, w and scale must be 16-byte aligned")
    stream = torch._C._cuda_getCurrentRawStream(idx)
    f32 = out_dtype is torch.float32
    # a weight's address names it for as long as it lives, with its shape
    key = (pw, m, K, N, int4, stream, f32)
    got = _CALLS.get(key)
    if got is None:
        got = _CALLS[key] = _prepare(x, w, pw, int4, f32, stream, what)
    wmap, xmap, pws, pflags, kind, ctas, cluster, f32_arg, _ = got
    out = torch.empty((m, N), dtype=out_dtype, device=x.device)
    rc = _entry()(wmap, xmap, pw, px, ps, out.data_ptr(), pws, pflags, m, K,
                  N, kind, ctas, cluster, int4, f32_arg, stream)
    if rc:
        _build.check(_build.load("int8_matmul"), rc, what)
    return out


def _matmul(x, w, scale, out_dtype, int4: bool):
    global launches, int4_launches
    out_dtype = out_dtype or x.dtype
    what = "int4_weight_matmul" if int4 else "int8_weight_matmul"
    plain = int4_weight_matmul_reference if int4 \
        else int8_weight_matmul_reference
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{what}: x and w must be 2-D, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    m, K = x.shape
    if w.shape[0] * (2 if int4 else 1) != K or scale.shape != (w.shape[1],):
        raise ValueError(f"{what}: x {tuple(x.shape)}, w {tuple(w.shape)} "
                         f"and scale {tuple(scale.shape)} disagree")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return plain(x, w, scale, out_dtype)
        raise ValueError(f"{what}: unsupported device {x.device}")
    if not kernel_takes(m, K, w.shape[1], int4):
        # the JAX package computes these shapes outside Pallas as well
        return plain(x, w, scale, out_dtype)
    out = _launch(x, w, scale, out_dtype, int4, what)
    if int4:
        int4_launches += 1
    else:
        launches += 1
    return out


def int8_weight_matmul(x, w_q, scale, out_dtype=None):
    """``x [m, K] @ dequant(w_q [K, N] int8, scale [N])`` -> ``[m, N]`` in
    ``out_dtype`` (default ``x.dtype``)."""
    return _matmul(x, w_q, scale, out_dtype, int4=False)


def int4_weight_matmul(x, w_packed, scale, out_dtype=None):
    """``x [m, K] @ dequant(unpack(w_packed [K/2, N]), scale [N])`` ->
    ``[m, N]`` in ``out_dtype`` (default ``x.dtype``)."""
    return _matmul(x, w_packed, scale, out_dtype, int4=True)


# ------------------------------------------------------------------------
# The decode kernel's fragment layout (``csrc/int8_matmul.cu``, kernel 1),
# modelled in numpy: the contract its index math keeps.


def _prmt(a, b, sel: int):
    """CUDA's ``__byte_perm``: byte i of the result is byte ``(sel >> 4 i)
    & 7`` of the eight bytes of ``(a, b)`` (uint32 arrays)."""
    a = np.asarray(a, dtype=np.uint64)
    b = np.asarray(b, dtype=np.uint64)
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] \
        + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros(np.broadcast(a, b).shape, dtype=np.uint64)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << np.uint64(8 * i)
    return out.astype(np.uint32)


def _halves(v):
    """A bf16 pair (uint32) as two f32 arrays: the low half, the high."""
    v = np.asarray(v, dtype=np.uint32)
    return ((v & 0xFFFF) << 16).view(np.float32), \
        (v & 0xFFFF0000).view(np.float32)


def _i8_pair(r0, r1, j: int):
    """``i8_pair``: byte j of rows k (r0) and k + 1 (r1), biased by 128, as
    a bf16 pair through the f32 2^23 + byte."""
    base = np.float32(8388608.0 + 128.0)
    f0 = _prmt(r0, 0x4B000000, 0x7440 + j).view(np.float32) - base
    f1 = _prmt(r1, 0x4B000000, 0x7440 + j).view(np.float32) - base
    return _prmt(f0.view(np.uint32), f1.view(np.uint32), 0x7632)


def _nib_pair(u):
    """``nib_pair``: the nibbles in bits 0-3 and 16-19 as a signed bf16
    pair: 0x4300 | (nibble ^ 8), times 1, minus 136."""
    v = (np.asarray(u, dtype=np.uint32) & 0x000F000F) ^ 0x43084308
    lo, hi = _halves(v)
    lo, hi = lo - np.float32(136), hi - np.float32(136)
    return (lo.view(np.uint32) >> 16) | (hi.view(np.uint32) & 0xFFFF0000)


def _i4_pairs(p0, p1, j: int):
    """``i4_pairs``: columns j, j + 1 of packed rows p, p + 1 as (lo_j,
    lo_j+1, hi_j, hi_j+1)."""
    v = _prmt(p0, p1, 0x5410 if j == 0 else 0x7632)
    return _nib_pair(v), _nib_pair(v >> 8), _nib_pair(v >> 4), \
        _nib_pair(v >> 12)


def decode_fragment_model(x, w, scale, int4: bool, bn: int, warps: int = 4):
    """The decode kernel's data flow, lane by lane, in numpy: ``x [m, K]``
    (bf16 values, m <= 64), the int8 ``w [K, N]`` or half-split int4 ``[K/2,
    N]`` bytes and ``scale [N]`` -> ``(sum_k x w) * scale`` in float64.

    Per tile of ``bn`` columns, warp (``bn / warps`` columns) and 16-row
    slice of weight bytes, lane (g, t) loads 4 bytes, columns ``cb = warp
    bn / warps + 4 g`` .. + 3, from rows 2t, 2t+1, 2t+8, 2t+9 and converts
    them as the source does (``i8_pair`` / ``i4_pairs``) into the A
    registers of tiles i = 0, 1: a0 = (A row g, k 2t..2t+1) from column cb
    + 2 i, a1 = row g + 8 from column cb + 2 i + 1, a2 and a3 the same at k
    + 8. The m16n8k16 product of those fragments with x's 8-row tiles gives
    C row g (g + 8), column c = output column cb + 2 i (+ 1), row 8 mt + c;
    int4's words feed a second product against x's columns K/2 + ...."""
    x = np.asarray(x, dtype=np.float64)
    wb = np.ascontiguousarray(np.asarray(w, dtype=np.int8)).view(np.uint8)
    m, K = x.shape
    N = wb.shape[1]
    mt_n = -(-m // 8)
    xp = np.zeros((8 * mt_n, K))
    xp[:m] = x
    out = np.zeros((8 * mt_n, N))
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    half = K // 2

    def words(rows, cols):   # little-endian uint32 of 4 bytes a lane
        b = wb[rows[:, None], cols[:, None] + np.arange(4)].astype(np.uint32)
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)

    def product(a, k0, c_rows, n_cols):
        A = np.zeros((16, 16))
        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
            lo, hi = _halves(a[reg])
            A[g + dr, 2 * t + dk] = lo
            A[g + dr, 2 * t + dk + 1] = hi
        for mt in range(mt_n):
            B = xp[8 * mt:8 * mt + 8, k0:k0 + 16].T           # [k, m]
            C = A @ B
            out[8 * mt:8 * mt + 8, n_cols[c_rows]] += C.T

    for n0 in range(0, N, bn):
        for wp in range(warps):
            cb = n0 + wp * (bn // warps) + 4 * g
            for r0 in range(0, wb.shape[0], 16):
                rows = [r0 + 2 * t + d for d in (0, 1, 8, 9)]
                r = [words(rr, cb) for rr in rows]
                if not int4:
                    r = [v ^ np.uint32(0x80808080) for v in r]
                for i in range(2):
                    j = 2 * i
                    # C rows 0..15 -> output columns: row g is cb + 2 i at
                    # lane group g, row g + 8 is cb + 2 i + 1
                    ncol = np.concatenate([cb[::4] + j, cb[::4] + j + 1])
                    if not int4:
                        a = [_i8_pair(r[0], r[1], j),
                             _i8_pair(r[0], r[1], j + 1),
                             _i8_pair(r[2], r[3], j),
                             _i8_pair(r[2], r[3], j + 1)]
                        product(a, r0, np.arange(16), ncol)
                    else:
                        lo0, lo1, hi0, hi1 = _i4_pairs(r[0], r[1], j)
                        lo2, lo3, hi2, hi3 = _i4_pairs(r[2], r[3], j)
                        product([lo0, lo1, lo2, lo3], r0, np.arange(16), ncol)
                        product([hi0, hi1, hi2, hi3], half + r0,
                                np.arange(16), ncol)
    return out[:m] * np.asarray(scale, dtype=np.float64)[None, :]
