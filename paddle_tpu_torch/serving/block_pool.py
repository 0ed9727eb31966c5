"""KV block pool for the continuous-batching runtime (the counterpart of
``paddle_tpu/serving/block_pool.py``).

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

Shared-prefix cache (``prefix_cache=True``, optimistic mode only): every
full prompt block is addressed by a chained sha1 over the token prefix it
completes, salted with the block size. ``admit`` maps cached blocks into
the new request's table (refcount + 1) and only the uncached tail is
prefilled. Writes always land in blocks of the request's own: decode
appends past the shared prefix and the partial last prompt block is never
shared, so a cached block never changes while it is cached. A released
sharer drops the refcount; at 0 the block waits on an LRU list, still
counted as free capacity, until an allocation finds the free list empty
and evicts it (its cache entry dropped).

A speculative drafter (``draft_spec``) keeps page buffers of its own
geometry indexed by the same block ids, so admission, sharing,
preemption, quarantine and release move one set of ids for both models.

Every mutation is exception-safe: ``_bind_block`` checks (and hosts the
``pool.bind_oom`` point) before it changes anything, ``_take_block``
hosts ``pool.evict_fail`` before an eviction touches the cache index, and
``admit`` rolls a partly bound slot back to the state before it, shared
refcounts included, before it re-raises.

Telemetry: the prefix counters and the occupancy gauges (free, evictable,
in use, cached blocks, utilization, hit rate, bytes a block) live in the
metrics registry under ``metrics_labels`` (the engine's label; a pool
built alone gets ``engine=pool-<n>``). The gauges read the pool through a
weak reference when a snapshot is taken.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import faults, metrics
from .router import chain_keys

__all__ = ["BlockPool", "BlockPoolExhausted"]


class BlockPoolExhausted(RuntimeError):
    """Raised in optimistic mode when no block is free or evictable: the
    engine's preemption trigger (in reservation mode exhaustion is an
    accounting bug and raises a plain ``RuntimeError``)."""


class BlockPool:
    """Preallocated paged-KV storage + host-side block/slot allocator."""

    def __init__(self, spec, max_seq_len: int, num_blocks: int,
                 max_slots: int, optimistic: bool = False,
                 prefix_cache: bool = False, draft_spec=None, device="cpu",
                 metrics_labels: Optional[Dict[str, str]] = None):
        if num_blocks < 2:
            raise ValueError("BlockPool needs >= 2 blocks (block 0 is the "
                             "reserved null block)")
        if prefix_cache and not optimistic:
            raise ValueError(
                "BlockPool(prefix_cache=True) requires optimistic=True — "
                "worst-case reservation accounting cannot describe shared "
                "blocks")
        self.spec = spec
        self.device = torch.device(device)
        self.block_size = spec.page_size
        self.max_seq_len = int(max_seq_len)
        self.pages_per_seq = spec.pages_per_seq(max_seq_len)
        self.num_blocks = int(num_blocks)
        self.max_slots = int(max_slots)
        self.optimistic = bool(optimistic)
        self.prefix_cache = bool(prefix_cache)
        self.k_pages, self.v_pages = spec.alloc_pool(num_blocks, self.device)
        self.k_scales = self.v_scales = None
        if spec.quantized:
            self.k_scales, self.v_scales = spec.alloc_scales(num_blocks,
                                                             self.device)
        self.draft_spec = draft_spec
        self.draft_k_pages = self.draft_v_pages = None
        self.draft_k_scales = self.draft_v_scales = None
        if draft_spec is not None:
            if draft_spec.page_size != spec.page_size \
                    or draft_spec.quantized != spec.quantized:
                raise ValueError(
                    f"BlockPool: the draft cache (page {draft_spec.page_size}"
                    f", cache_dtype {draft_spec.cache_dtype!r}) must share "
                    f"the pool's block size {spec.page_size} and "
                    f"quantization ({spec.cache_dtype!r}): one block id "
                    f"covers the same tokens in both")
            self.draft_k_pages, self.draft_v_pages = draft_spec.alloc_pool(
                num_blocks, self.device)
            if spec.quantized:
                self.draft_k_scales, self.draft_v_scales = \
                    draft_spec.alloc_scales(num_blocks, self.device)
        self.table = np.zeros((max_slots, self.pages_per_seq), np.int32)
        self.lens = np.zeros((max_slots,), np.int32)
        self._free_blocks: List[int] = list(range(num_blocks - 1, 0, -1))
        self._free_slots: List[int] = list(range(max_slots - 1, -1, -1))
        self._slot_blocks: List[List[int]] = [[] for _ in range(max_slots)]
        self._slot_reserved: List[int] = [0] * max_slots
        self._slot_cached_tokens: List[int] = [0] * max_slots
        self._reserved_total = 0
        self.peak_blocks_in_use = 0
        self.prefix_queries = 0
        self.prefix_hit_blocks = 0
        self.prefix_miss_blocks = 0
        self.prefix_saved_tokens = 0
        self.cache_evictions = 0
        # prefix cache index: key -> block of every registered full prompt
        # block; refcounts cover registered blocks only (the owner counts
        # while bound); refcount-0 blocks sit in _evictable, oldest first
        self._cached: Dict[str, int] = {}
        self._block_key: Dict[int, str] = {}
        self._refcount: Dict[int, int] = {}
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.metrics_labels = dict(metrics_labels or {
            "engine": f"pool-{metrics.next_instance_id('pool')}"})
        lbl = self.metrics_labels
        mc = lambda name, doc: metrics.counter(  # noqa: E731
            name, doc=doc, owner=self, **lbl)
        self._m_prefix_queries = mc("serving.pool.prefix_queries",
                                    "Prefix-cache lookups at admission.")
        self._m_prefix_hit_blocks = mc(
            "serving.pool.prefix_hit_blocks",
            "Full prompt blocks served from the prefix cache.")
        self._m_prefix_miss_blocks = mc(
            "serving.pool.prefix_miss_blocks",
            "Full prompt blocks that had to be prefilled.")
        self._m_prefix_saved_tokens = mc(
            "serving.pool.prefix_saved_tokens",
            "Prefill tokens skipped thanks to cached prefix blocks.")
        self._m_cache_evictions = mc(
            "serving.pool.cache_evictions",
            "Refcount-0 cached blocks reclaimed under pool pressure.")
        self._m_peak_blocks_in_use = metrics.gauge(
            "serving.pool.peak_blocks_in_use",
            doc="High-water mark of blocks in use.", owner=self, **lbl)
        for gname, fn, doc in (
                ("serving.pool.free_blocks", lambda p: p.free_blocks,
                 "Blocks an allocation could obtain right now (free list "
                 "+ evictable cached blocks) — router placement input."),
                ("serving.pool.evictable_blocks", lambda p: len(p._evictable),
                 "Refcount-0 cached blocks (reclaimable capacity)."),
                ("serving.pool.blocks_in_use", lambda p: p.blocks_in_use,
                 "Usable blocks currently bound or cache-referenced."),
                ("serving.pool.num_blocks", lambda p: p.usable_blocks,
                 "Usable pool capacity (excludes the null block)."),
                ("serving.pool.cached_blocks", lambda p: len(p._cached),
                 "Registered shared-prefix blocks."),
                ("serving.pool.utilization",
                 lambda p: p.blocks_in_use / max(p.usable_blocks, 1),
                 "blocks_in_use / usable capacity."),
                ("serving.pool.prefix_hit_rate", lambda p: p._hit_rate(),
                 "Lifetime prefix-cache block hit rate — router "
                 "prefix-affinity input."),
                ("serving.pool.bytes_per_block",
                 lambda p: p.spec.bytes_per_block,
                 "Device bytes one pool block pins (an int8 pool counts "
                 "its f32 scales too).")):
            metrics.gauge(gname, doc=doc, callback=fn, owner=self, **lbl)

    # -- capacity queries ----------------------------------------------------
    @property
    def usable_blocks(self) -> int:
        """Blocks a request could ever use (excludes the null block)."""
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        """Blocks an allocation could take now: the free list plus the
        refcount-0 cached blocks."""
        return len(self._free_blocks) + len(self._evictable)

    @property
    def available_blocks(self) -> int:
        """Free blocks not promised to a running request."""
        return self.free_blocks - self._reserved_total

    @property
    def blocks_in_use(self) -> int:
        return self.usable_blocks - self.free_blocks

    def _note_peak(self) -> None:
        self.peak_blocks_in_use = max(self.peak_blocks_in_use,
                                      self.blocks_in_use)
        self._m_peak_blocks_in_use.set_to_max(self.blocks_in_use)

    def _hit_rate(self) -> float:
        looked = self.prefix_hit_blocks + self.prefix_miss_blocks
        return self.prefix_hit_blocks / looked if looked else 0.0

    # -- prefix cache index ---------------------------------------------------
    def _chain_keys(self, tokens: np.ndarray, n_blocks: int) -> List[str]:
        """Keys of the first ``n_blocks`` full blocks of ``tokens``: key i
        hashes the whole prefix through block i, salted with the block
        size, so a block is shared only when everything before it matches
        too. The router's :func:`~.router.chain_keys`, so a fleet's
        affinity probe and the pool's lookup never disagree."""
        return chain_keys(tokens, self.block_size, n_blocks)

    def _match_prefix(self, tokens: np.ndarray) -> Tuple[List[int], int]:
        """The longest cached chain of full blocks of ``tokens``:
        ``(blocks, cacheable)``, capped at ``(len - 1) // block_size``
        blocks so that at least one token is prefilled (its logits give
        the first token)."""
        if not self.prefix_cache:
            return [], 0
        n_max = (len(tokens) - 1) // self.block_size
        hits: List[int] = []
        for key in self._chain_keys(tokens, n_max):
            phys = self._cached.get(key)
            if phys is None:
                break
            hits.append(phys)
        return hits, n_max

    def _take_block(self) -> int:
        """One block: the free list first, else evict the LRU refcount-0
        cached block, else :class:`BlockPoolExhausted`."""
        if self._free_blocks:
            return self._free_blocks.pop()
        if self._evictable:
            # before any mutation: a raise leaves the index consistent
            faults.fire("pool.evict_fail")
            phys, _ = self._evictable.popitem(last=False)
            del self._cached[self._block_key.pop(phys)]
            del self._refcount[phys]
            self.cache_evictions += 1
            self._m_cache_evictions.inc()
            return phys
        raise BlockPoolExhausted(
            f"block pool exhausted: 0 free of {self.usable_blocks} usable "
            f"blocks ({len(self._cached)} cached, all referenced)")

    def _map_shared(self, slot: int, logical: int, phys: int) -> None:
        """Map a cached block into a slot's table, read-only: refcount + 1,
        not evictable while referenced."""
        self._refcount[phys] += 1
        self._evictable.pop(phys, None)
        self._slot_blocks[slot].append(phys)
        self.table[slot, logical] = phys
        self._note_peak()

    def chain_hits(self, keys) -> int:
        """How many leading entries of a ``_chain_keys``-style key list are
        cached now. Read-only: no counter moves, the LRU order stays."""
        if not self.prefix_cache:
            return 0
        n = 0
        for key in keys:
            if key not in self._cached:
                break
            n += 1
        return n

    def cached_prefix_len(self, slot: int) -> int:
        """Tokens ``slot`` got from the prefix cache at admission (its
        prefill starts after them)."""
        return self._slot_cached_tokens[slot]

    def register_prefix(self, slot: int, tokens: np.ndarray) -> int:
        """Publish the slot's prefilled full blocks of ``tokens`` to the
        prefix cache (once, when its prefill completes). The partial last
        block and every decode block stay private. A key already cached
        keeps its first block; this slot's copy stays private. Returns
        the number of blocks registered."""
        if not self.prefix_cache:
            return 0
        new = 0
        keys = self._chain_keys(tokens, len(tokens) // self.block_size)
        for logical, key in enumerate(keys):
            phys = int(self.table[slot, logical])
            if phys == 0 or phys in self._block_key or key in self._cached:
                continue
            self._cached[key] = phys
            self._block_key[phys] = key
            self._refcount[phys] = 1          # the owner, while bound
            new += 1
        return new

    # -- admission / growth / release ---------------------------------------
    def _admission_block(self, prompt_len: int, max_new_tokens: int,
                         hits: List[int]) -> Optional[str]:
        """The one admission predicate, over an already walked match:
        :meth:`blocked_reason` and :meth:`admit` both use it."""
        if not self._free_slots:
            return "no_free_slot"
        if self.optimistic:
            need = self.spec.blocks_for(prompt_len) - len(hits)
            # an evictable hit is mapped, not taken: it must not also count
            # as capacity for the tail's binds
            takable = self.free_blocks \
                - sum(1 for p in hits if p in self._evictable)
            return "pool_full" if takable < need else None
        total = self.spec.blocks_for(prompt_len + max_new_tokens)
        return "pool_full" if self.available_blocks < total else None

    def _probe_hits(self, tokens: Optional[np.ndarray]
                    ) -> Tuple[List[int], int]:
        if tokens is not None and self.prefix_cache:
            return self._match_prefix(tokens)
        return [], 0

    def blocked_reason(self, prompt_len: int, max_new_tokens: int,
                       tokens: Optional[np.ndarray] = None) -> Optional[str]:
        """Why :meth:`admit` would refuse now (``"no_free_slot"`` or
        ``"pool_full"``), or None."""
        hits, _ = self._probe_hits(tokens)
        return self._admission_block(prompt_len, max_new_tokens, hits)

    def admit(self, prompt_len: int, max_new_tokens: int,
              tokens: Optional[np.ndarray] = None) -> Optional[int]:
        """Bind the blocks a request needs now (and, reservation mode,
        promise the rest), mapping cached prefix blocks of ``tokens``.
        Returns its slot, or None as backpressure with nothing changed."""
        total = self.spec.blocks_for(prompt_len + max_new_tokens)
        if total > self.pages_per_seq:
            raise ValueError(
                f"request needs {total} blocks but a sequence holds at "
                f"most pages_per_seq={self.pages_per_seq} "
                f"({self.max_seq_len} tokens at block_size "
                f"{self.block_size})")
        hits, n_max = self._probe_hits(tokens)
        if self._admission_block(prompt_len, max_new_tokens,
                                 hits) is not None:
            return None
        if tokens is not None and self.prefix_cache:
            # admitted requests only: a blocked head retrying every
            # iteration does not inflate the counters
            self.prefix_queries += 1
            self.prefix_hit_blocks += len(hits)
            self.prefix_miss_blocks += n_max - len(hits)
            self._m_prefix_queries.inc()
            self._m_prefix_hit_blocks.inc(len(hits))
            self._m_prefix_miss_blocks.inc(n_max - len(hits))
        slot = self._free_slots.pop()
        # the slot's remaining block budget; reservation mode also promises
        # it pool-wide
        self._slot_reserved[slot] = total - len(hits)
        if not self.optimistic:
            self._reserved_total += total
        try:
            for logical, phys in enumerate(hits):
                self._map_shared(slot, logical, phys)
            for logical in range(len(hits), self.spec.blocks_for(prompt_len)):
                self._bind_block(slot, logical)
        except BaseException:
            # roll the slot all the way back: bound blocks freed, shared
            # refcounts dropped, the reservation and the slot returned
            self.release(slot)
            raise
        self._slot_cached_tokens[slot] = len(hits) * self.block_size
        self.prefix_saved_tokens += self._slot_cached_tokens[slot]
        self._m_prefix_saved_tokens.inc(self._slot_cached_tokens[slot])
        self.lens[slot] = 0   # the engine sets the real length as it prefills
        return slot

    def _bind_block(self, slot: int, logical: int) -> int:
        # check and inject before any mutation
        if self._slot_reserved[slot] <= 0:
            raise RuntimeError(
                f"block pool: slot {slot} exceeded its block budget")
        faults.fire("pool.bind_oom")
        if not self.optimistic and not self._free_blocks:
            raise RuntimeError(
                f"block pool: free list exhausted binding logical block "
                f"{logical} of slot {slot} — reservation accounting is "
                f"violated ({self._reserved_total} reserved)")
        phys = self._take_block()
        self._slot_reserved[slot] -= 1
        if not self.optimistic:
            self._reserved_total -= 1
        self._slot_blocks[slot].append(phys)
        self.table[slot, logical] = phys
        self._note_peak()
        return phys

    def ensure_decode_span(self, slot: int, span: int) -> None:
        """Bind every block of positions ``[lens[slot], lens[slot] +
        span)``: the next token's (span 1), or a speculative verify
        window's. The engine caps the span at the request's token budget;
        blocks a failed attempt already bound are skipped on the next.
        Optimistic mode raises :class:`BlockPoolExhausted` when no block
        is free."""
        pos = int(self.lens[slot])
        first = pos // self.block_size
        if pos % self.block_size == 0 and first >= self.pages_per_seq:
            raise RuntimeError(
                f"block pool: slot {slot} is full ({pos} tokens) — the "
                f"engine decoded past max_seq_len")
        last = min(-(-(pos + max(int(span), 1)) // self.block_size),
                   self.pages_per_seq) - 1
        for logical in range(first, last + 1):
            if self.table[slot, logical] == 0:
                self._bind_block(slot, logical)

    def release(self, slot: int) -> int:
        """Reclaim a finished, preempted or quarantined request's slot: its
        own blocks return to the free list, shared blocks lose a reference
        (at 0 they turn evictable and stay cached). Returns the number of
        blocks the slot referenced."""
        blocks = self._slot_blocks[slot]
        for phys in blocks:
            if phys in self._refcount:
                self._refcount[phys] -= 1
                if self._refcount[phys] == 0:
                    self._evictable[phys] = None       # LRU append
            else:
                self._free_blocks.append(phys)
        self._slot_blocks[slot] = []
        if not self.optimistic:
            self._reserved_total -= self._slot_reserved[slot]
        self._slot_reserved[slot] = 0
        self._slot_cached_tokens[slot] = 0
        self.table[slot, :] = 0
        self.lens[slot] = 0
        self._free_slots.append(slot)
        return len(blocks)

    # -- device views --------------------------------------------------------
    def device_tables(self, active_slots=None):
        """(page_table, seq_lens) as int32 tensors on the pool's device,
        and the same lens on the host (the speculative draft loop's
        position math reads them). ``active_slots`` masks every other row
        to the null block with length 0, so a slot mid-prefill cannot be
        written by decode."""
        table, lens = self.table, self.lens
        if active_slots is not None:
            keep = np.zeros((self.max_slots,), bool)
            keep[list(active_slots)] = True
            table = np.where(keep[:, None], table, 0).astype(np.int32)
            lens = np.where(keep, lens, 0).astype(np.int32)
        lens = np.array(lens, np.int32)
        return (torch.from_numpy(np.ascontiguousarray(table)).to(self.device),
                torch.from_numpy(lens.copy()).to(self.device), lens)

    def stats(self) -> Dict[str, float]:
        in_use = self.blocks_in_use
        return {
            "num_blocks": self.usable_blocks,
            "bytes_per_block": self.spec.bytes_per_block,
            "draft_bytes_per_block": (self.draft_spec.bytes_per_block
                                      if self.draft_spec is not None else 0),
            "free_blocks": self.free_blocks,
            "reserved_blocks": self._reserved_total,
            "blocks_in_use": in_use,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "live_tokens": int(self.lens.sum()),
            "utilization": in_use / max(self.usable_blocks, 1),
            "cached_blocks": len(self._cached),
            "evictable_blocks": len(self._evictable),
            "prefix_queries": self.prefix_queries,
            "prefix_hit_blocks": self.prefix_hit_blocks,
            "prefix_miss_blocks": self.prefix_miss_blocks,
            "prefix_hit_rate": self._hit_rate(),
            "prefix_saved_tokens": self.prefix_saved_tokens,
            "cache_evictions": self.cache_evictions,
        }
