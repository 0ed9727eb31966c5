"""KV-cache geometry shared by the prefill scratch caches and the serving
pool (the native-dtype part of ``paddle_tpu/models/kv_cache.py``).

Dense layout ``[L, B, S, kvh, dh]``; pooled paged layout
``[L, kvh, num_blocks, page, dh]`` whose block ids a block table maps per
sequence (block 0 is the null block).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.dtype import itemsize, to_torch_dtype

__all__ = ["KVCacheSpec", "check_request_fits"]


@dataclass(frozen=True)
class KVCacheSpec:
    """Geometry of one model's KV cache, independent of batch and length.
    The port stores the pool in the model dtype only."""

    num_layers: int
    num_kv_heads: int
    head_dim: int
    page_size: int = 16
    dtype: str = "float32"

    @classmethod
    def from_config(cls, cfg, page_size: int = 16) -> "KVCacheSpec":
        return cls(num_layers=cfg.num_hidden_layers,
                   num_kv_heads=cfg.num_key_value_heads,
                   head_dim=cfg.head_dim, page_size=int(page_size),
                   dtype="bfloat16" if cfg.dtype == "bfloat16"
                   else "float32")

    @property
    def torch_dtype(self) -> torch.dtype:
        return to_torch_dtype(self.dtype)

    @property
    def bytes_per_token(self) -> int:
        """K + V bytes one cached token costs across all layers."""
        return (2 * self.num_layers * self.num_kv_heads * self.head_dim
                * itemsize(self.dtype))

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

    def pool_shape(self, num_blocks: int):
        return (self.num_layers, self.num_kv_heads, num_blocks,
                self.page_size, self.head_dim)

    def alloc_dense(self, batch: int, max_len: int, device):
        k = torch.zeros(self.dense_shape(batch, max_len),
                        dtype=self.torch_dtype, device=device)
        return k, torch.zeros_like(k)

    def alloc_pool(self, num_blocks: int, device):
        k = torch.zeros(self.pool_shape(num_blocks), dtype=self.torch_dtype,
                        device=device)
        return k, torch.zeros_like(k)


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
