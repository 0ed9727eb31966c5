"""KV block pool for the continuous-batching runtime (the counterpart of
``paddle_tpu/serving/block_pool.py`` without the prefix cache).

The pool owns one preallocated pair of page tensors
``[L, kvh, num_blocks, block, dh]`` on the device (int8 on a quantized
spec, with a parallel pair of f32 scales pools ``[L, num_blocks, kvh,
block]``, ``k_scales``/``v_scales``, else None) plus the per-slot block
tables the paged kernel reads, and hands out and reclaims physical block
ids on the host; a block id covers its scales too. Block 0 is the null
block: idle decode rows write their garbage there and unallocated logical
blocks point at it.

Two admission modes:

* worst-case reservation (``optimistic=False``): admission reserves
  ``blocks_for(prompt + max_new_tokens)`` so a running request never
  starves mid-decode;
* optimistic (``optimistic=True``): admission binds only the prompt's
  blocks, decode growth binds lazily, and an exhausted pool raises
  :class:`BlockPoolExhausted` — the engine's signal to preempt.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["BlockPool", "BlockPoolExhausted"]


class BlockPoolExhausted(RuntimeError):
    """Raised in optimistic mode when no block is free: the engine's
    preemption trigger (in reservation mode exhaustion is an accounting
    bug and raises a plain ``RuntimeError``)."""


class BlockPool:
    """Preallocated paged-KV storage + host-side block/slot allocator."""

    def __init__(self, spec, max_seq_len: int, num_blocks: int,
                 max_slots: int, optimistic: bool = False, device="cpu"):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (block 0 is the "
                             "reserved null block)")
        self.spec = spec
        self.device = torch.device(device)
        self.block_size = spec.page_size
        self.max_seq_len = int(max_seq_len)
        self.pages_per_seq = spec.pages_per_seq(max_seq_len)
        self.num_blocks = int(num_blocks)
        self.max_slots = int(max_slots)
        self.optimistic = bool(optimistic)
        self.k_pages, self.v_pages = spec.alloc_pool(num_blocks, self.device)
        self.k_scales = self.v_scales = None
        if spec.quantized:
            self.k_scales, self.v_scales = spec.alloc_scales(num_blocks,
                                                             self.device)
        self.table = np.zeros((max_slots, self.pages_per_seq), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)
        self._free_blocks: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_reserved: List[int] = [0] * max_slots
        self._reserved_total = 0
        self.peak_blocks_in_use = 0

    # -- capacity queries ----------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Blocks a request could ever use (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def available_blocks(self) -> int:
        """Free blocks not promised to a running request."""
        return self.free_blocks - self._reserved_total

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - self.free_blocks

    # -- admission / growth / release ---------------------------------------
    def blocked_reason(self, prompt_len: int,
                       max_new_tokens: int) -> Optional[str]:
        """Why :meth:`admit` would refuse now (``"no_free_slot"`` or
        ``"pool_full"``), or None."""
        if not self._free_slots:
            return "no_free_slot"
        if self.optimistic:
            need = self.spec.blocks_for(prompt_len)
            return "pool_full" if self.free_blocks < need else None
        total = self.spec.blocks_for(prompt_len + max_new_tokens)
        return "pool_full" if self.available_blocks < total else None

    def admit(self, prompt_len: int, max_new_tokens: int) -> Optional[int]:
        """Bind the blocks a request needs now (and, reservation mode,
        promise the rest). Returns its slot, or None as backpressure."""
        total = self.spec.blocks_for(prompt_len + max_new_tokens)
        if total > self.pages_per_seq:
            raise ValueError(
                f"request needs {total} blocks but a sequence holds at "
                f"most pages_per_seq={self.pages_per_seq} "
                f"({self.max_seq_len} tokens at block_size "
                f"{self.block_size})")
        if self.blocked_reason(prompt_len, max_new_tokens) is not None:
            return None
        slot = self._free_slots.pop()
        self._slot_reserved[slot] = total
        if not self.optimistic:
            self._reserved_total += total
        for logical in range(self.spec.blocks_for(prompt_len)):
            self._bind_block(slot, logical)
        self.lens[slot] = 0   # the engine sets the real length as it prefills
        return slot

    def _bind_block(self, slot: int, logical: int) -> int:
        if self._slot_reserved[slot] <= 0:
            raise RuntimeError(
                f"block pool: slot {slot} exceeded its block budget")
        if not self._free_blocks:
            if self.optimistic:
                raise BlockPoolExhausted(
                    f"block pool exhausted: 0 free of {self.usable_blocks} "
                    f"usable blocks")
            raise RuntimeError(
                f"block pool: free list exhausted binding logical block "
                f"{logical} of slot {slot} — reservation accounting is "
                f"violated ({self._reserved_total} reserved)")
        phys = self._free_blocks.pop()
        self._slot_reserved[slot] -= 1
        if not self.optimistic:
            self._reserved_total -= 1
        self._slot_blocks[slot].append(phys)
        self.table[slot, logical] = phys
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        return phys

    def ensure_decode_block(self, slot: int) -> None:
        """Bind the block the next token (position ``lens[slot]``) lands in
        when decode crosses a block boundary. Optimistic mode raises
        :class:`BlockPoolExhausted` when none is free."""
        pos = int(self.lens[slot])
        logical = pos // self.block_size
        if logical >= self.pages_per_seq:
            raise RuntimeError(
                f"block pool: slot {slot} is full ({pos} tokens) — the "
                f"engine decoded past max_seq_len")
        if self.table[slot, logical] == 0:
            self._bind_block(slot, logical)

    def release(self, slot: int) -> int:
        """Reclaim a finished or preempted request's blocks and slot.
        Returns the number of blocks it held."""
        blocks = self._slot_blocks[slot]
        n = len(blocks)
        self._free_blocks.extend(blocks)
        self._slot_blocks[slot] = []
        if not self.optimistic:
            self._reserved_total -= self._slot_reserved[slot]
        self._slot_reserved[slot] = 0
        self.table[slot, :] = 0
        self.lens[slot] = 0
        self._free_slots.append(slot)
        return n

    # -- device views --------------------------------------------------------
    def device_tables(self, active_slots=None):
        """(page_table, seq_lens) as int32 tensors on the pool's device.
        ``active_slots`` masks every other row to the null block with
        length 0, so a slot mid-prefill cannot be written by decode."""
        table, lens = self.table, self.lens
        if active_slots is not None:
            keep = np.zeros((self.max_slots,), bool)
            keep[list(active_slots)] = True
            table = np.where(keep[:, None], table, 0).astype(np.int32)
            lens = np.where(keep, lens, 0).astype(np.int32)
        return (torch.from_numpy(np.ascontiguousarray(table)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(lens)).to(self.device))

    def stats(self) -> Dict[str, float]:
        in_use = self.blocks_in_use
        return {
            "num_blocks": self.usable_blocks,
            "bytes_per_block": self.spec.bytes_per_block,
            "free_blocks": self.free_blocks,
            "reserved_blocks": self._reserved_total,
            "blocks_in_use": in_use,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "live_tokens": int(self.lens.sum()),
            "utilization": in_use / max(self.usable_blocks, 1),
        }
