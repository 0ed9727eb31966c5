"""KV-cache geometry shared by the prefill scratch caches and the serving
pool (the counterpart of ``paddle_tpu/models/kv_cache.py``).

Dense layout ``[L, B, S, kvh, dh]``; pooled paged layout
``[L, kvh, num_blocks, page, dh]`` whose block ids a block table maps per
sequence (block 0 is the null block).

Quantized pool (``cache_dtype="int8"``): int8 pages plus a parallel scales
pool ``[L, num_blocks, kvh, page]`` f32, one absmax scale per cached token
per kv head per layer, block-major so a block's scales travel with its id.
Every producer (prefill scatter, decode commit) and consumer (the paged
kernel, its plain version, the chunked-prefill carry) goes through
:func:`quantize_kv` / :func:`dequantize_kv`, the JAX package's arithmetic.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.dtype import itemsize, to_torch_dtype

__all__ = ["KVCacheSpec", "check_request_fits", "quantize_kv",
           "dequantize_kv"]


def quantize_kv(x: torch.Tensor, eps: float = 1e-6):
    """Absmax int8 quantization along the last (head_dim) axis:
    ``x [..., dh]`` -> ``(q int8 [..., dh], scale f32 [...])`` with
    ``x ≈ q * scale``, in f32 (``paddle_tpu/models/kv_cache.py:67-77``;
    ``torch.round`` rounds half to even as ``jnp.round`` does)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(eps) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """``q [..., dh]`` int8 times ``scale [...]`` in f32, cast to
    ``dtype``: the two operations the kernel runs in registers."""
    return (q.float() * scale[..., None].float()).to(dtype)


@dataclass(frozen=True)
class KVCacheSpec:
    """Geometry of one model's KV cache, independent of batch and length."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 16
    dtype: str = "float32"
    #: pool storage dtype: "" stores the pool in ``dtype`` (the compute
    #: dtype), "int8" quantizes it with a parallel scales pool. Dense
    #: scratch caches stay in ``dtype``.
    cache_dtype: str = ""

    @classmethod
    def from_config(cls, cfg, page_size: int = 16,
                    cache_dtype: str = "") -> "KVCacheSpec":
        return cls(num_layers=cfg.num_hidden_layers,
                   num_kv_heads=cfg.num_key_value_heads,
                   head_dim=cfg.head_dim, page_size=int(page_size),
                   dtype="bfloat16" if cfg.dtype == "bfloat16"
                   else "float32",
                   cache_dtype=str(cache_dtype or ""))

    @property
    def storage_dtype(self) -> str:
        """The dtype pool blocks are stored in."""
        return self.cache_dtype or self.dtype

    @property
    def quantized(self) -> bool:
        """True when the pool stores int8 blocks and a scales pool."""
        s = self.storage_dtype
        itemsize(s)                        # unknown dtypes raise here
        if s == "int8" and self.cache_dtype != "int8":
            raise ValueError("KVCacheSpec: int8 storage must be requested "
                             "with cache_dtype='int8' (dtype stays the "
                             "compute dtype)")
        return s == "int8"

    @property
    def torch_dtype(self) -> torch.dtype:
        """Compute dtype of dense caches (and of an unquantized pool)."""
        return to_torch_dtype(self.dtype)

    @property
    def pool_torch_dtype(self) -> torch.dtype:
        """Storage dtype of the pool's page buffers."""
        return to_torch_dtype(self.storage_dtype)

    @property
    def bytes_per_token(self) -> int:
        """K + V bytes one cached token costs across all layers, with the
        f32 scale of each (token, kv head) on a quantized pool."""
        per_head = self.head_dim * itemsize(self.storage_dtype)
        if self.quantized:
            per_head += 4
        return 2 * self.num_layers * self.num_kv_heads * per_head

    @property
    def bytes_per_block(self) -> int:
        return self.bytes_per_token * self.page_size

    def pages_per_seq(self, max_len: int) -> int:
        return -(-int(max_len) // self.page_size)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache slots."""
        return -(-max(int(n_tokens), 0) // self.page_size)

    def dense_shape(self, batch: int, max_len: int):
        return (self.num_layers, batch, max_len, self.num_kv_heads,
                self.head_dim)

    def paged_contiguous_shape(self, batch: int, max_len: int):
        """Contiguous paged layout (``fused_generate(paged=True)``,
        ``ServingDecoder(paged=True)``): ``[L, kvh, B * pps, page, dh]``,
        sequence b owning pages ``[b * pps, (b + 1) * pps)``."""
        return (self.num_layers, self.num_kv_heads,
                batch * self.pages_per_seq(max_len), self.page_size,
                self.head_dim)

    def pool_shape(self, num_blocks: int):
        return (self.num_layers, self.num_kv_heads, num_blocks,
                self.page_size, self.head_dim)

    def alloc_dense(self, batch: int, max_len: int, device):
        k = torch.zeros(self.dense_shape(batch, max_len),
                        dtype=self.torch_dtype, device=device)
        return k, torch.zeros_like(k)

    def scales_shape(self, num_blocks: int):
        """Scales pool of a quantized pool: ``[L, num_blocks, kvh, page]``
        (block-major: one layer's ``[num_blocks, kvh, page]`` slice is the
        kernel's scale operand)."""
        return (self.num_layers, num_blocks, self.num_kv_heads,
                self.page_size)

    def alloc_pool(self, num_blocks: int, device):
        k = torch.zeros(self.pool_shape(num_blocks),
                        dtype=self.pool_torch_dtype, device=device)
        return k, torch.zeros_like(k)

    def alloc_scales(self, num_blocks: int, device):
        """``(k_scales, v_scales)`` of a quantized pool, all ones (a slot is
        written before any unmasked read; a zero scale would make the
        quantizer divide by 0)."""
        if not self.quantized:
            raise ValueError(f"KVCacheSpec.alloc_scales: the spec is not "
                             f"quantized (cache_dtype="
                             f"{self.cache_dtype!r}); scales pools exist for "
                             f"cache_dtype='int8' only")
        k = torch.ones(self.scales_shape(num_blocks), dtype=torch.float32,
                       device=device)
        return k, torch.ones_like(k)


def check_request_fits(prompt_len: int, max_new_tokens: int, capacity: int,
                       limit_name: str, request=None):
    """Raise ``ValueError`` naming the limit and the request when
    ``prompt_len + max_new_tokens`` exceeds ``capacity``."""
    need = int(prompt_len) + int(max_new_tokens)
    if need <= int(capacity):
        return
    who = f"request {request!r}" if request is not None else "the request"
    raise ValueError(
        f"{who} needs {need} cache slots (prompt {int(prompt_len)} tokens "
        f"+ max_new_tokens {int(max_new_tokens)}) but {limit_name} is "
        f"{int(capacity)} — shorten the prompt, lower max_new_tokens, or "
        f"raise {limit_name}")
