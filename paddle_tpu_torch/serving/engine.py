"""Continuous-batching serving engine for causal LMs (the counterpart of
``paddle_tpu/serving/engine.py``).

One ``ServingEngine`` owns a model's stacked fused weights, a KV
:class:`~paddle_tpu_torch.serving.block_pool.BlockPool` and an FCFS
:class:`~paddle_tpu_torch.serving.scheduler.Scheduler`, and drives an
iteration-level loop: every :meth:`step` admits queued requests, runs up
to ``prefill_token_budget`` tokens of (chunked) prefill, then one decode
step over every active slot.

Three step families, all greedy:

* ``prefill``: a whole cold prompt at offset 0, padded to a bucket ``S``,
  through ``fused_multi_transformer`` over an ``S``-long scratch cache
  (the flash kernel), then the prompt's k/v scattered into its blocks;
* ``prefill_carry``: one chunk at a carried offset (chunked prefill and
  preemption recompute) — the cached prefix is gathered from the pool into
  the scratch cache first;
* ``decode``: ``max_batch`` rows, one token each, through
  ``fused_multi_transformer_paged_ragged`` (the paged kernel); idle rows
  write into the null block.

PyTorch runs eagerly, so there is no trace cache or bucket warmup; the
buckets only round the prefill length. Pool writes are in place.

Quantized modes, in any combination: ``quantize`` (False, True = "int8",
"int8", "int4") stores the decoder's four weight stacks weight-only
quantized, and every product goes through the weight-only GEMM;
``kv_cache_dtype="int8"`` stores the pool as int8 pages with per-token
scales, quantized at every pool write and dequantized by the paged kernel
and by the chunked-prefill carry.

Not ported yet (each raises ``NotImplementedError`` naming the ROADMAP
entry): speculative decoding and the shared-prefix cache;
``prefix_cache`` resolves to False.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import entry_device
from ..incubate.nn.functional.fused_transformer import (
    fused_multi_transformer, fused_multi_transformer_paged_ragged,
    fused_weights_from_llama)
from ..models.generation import lm_head_tail
from ..models.kv_cache import (KVCacheSpec, check_request_fits,
                               dequantize_kv, quantize_kv)
from ..ops.cuda import flash_attention as _flash_cuda
from ..ops.cuda import int8_matmul as _wo_cuda
from ..ops.cuda import paged_attention as _paged_cuda
from ..ops.fused.rope import build_rope_cache
from .block_pool import BlockPool, BlockPoolExhausted
from .scheduler import Request, Scheduler

__all__ = ["ServingConfig", "ServingEngine"]

# The JAX package reads these from its FLAGS_serving_* registry; the port
# fixes the same defaults as constants.
SERVING_BLOCK_SIZE = 16
SERVING_MAX_BATCH = 8
SERVING_NUM_BLOCKS = 0          # 0 = max_batch * pages_per_seq + 1
SERVING_PREFILL_TOKEN_BUDGET = 512
SERVING_PREEMPTION = True
SERVING_KV_CACHE_DTYPE = ""     # "" = store the pool in the model dtype

_ROADMAP = "ROADMAP.md, queue A 'Serving breadth'"
_rid_counter = itertools.count()


def _default_buckets(max_seq_len: int) -> Tuple[int, ...]:
    buckets, s = [], 16
    while s < max_seq_len:
        buckets.append(s)
        s *= 2
    buckets.append(max_seq_len)
    return tuple(sorted(set(buckets)))


@dataclass
class ServingConfig:
    """Knobs of the continuous-batching runtime; the fields and defaults of
    the JAX ``ServingConfig``. Zero/None fields resolve to the constants
    above. ``quantize``: False, True (= "int8"), "int8" or "int4" weight-only
    quantization; ``kv_cache_dtype``: "" (the model dtype) or "int8".
    ``interpret`` and ``donate`` have no counterpart in eager PyTorch (no
    interpreter, writes are in place) and are ignored."""

    max_seq_len: int = 2048
    block_size: int = 0
    max_batch: int = 0
    num_blocks: int = 0
    prefill_token_budget: int = 0
    prefill_buckets: Optional[Tuple[int, ...]] = None
    quantize: object = False
    kv_cache_dtype: Optional[str] = None
    interpret: bool = False
    donate: Optional[bool] = None
    preemption: Optional[bool] = None
    prefix_cache: Optional[bool] = None
    speculative: Optional[tuple] = None

    def resolve(self) -> "ServingConfig":
        """A resolved copy; raises for the features the port lacks."""
        r = dataclasses.replace(self)
        if r.speculative is not None:
            raise NotImplementedError(
                f"ServingConfig.speculative: speculative decoding is not "
                f"ported yet ({_ROADMAP})")
        if r.quantize is True:
            r.quantize = "int8"
        elif not r.quantize:
            r.quantize = False
        elif r.quantize not in ("int8", "int4"):
            raise ValueError(f"ServingConfig.quantize {r.quantize!r} is not "
                             f"supported — False, True, 'int8' or 'int4'")
        if r.kv_cache_dtype is None:
            r.kv_cache_dtype = SERVING_KV_CACHE_DTYPE
        if r.kv_cache_dtype not in ("", "int8"):
            raise ValueError(
                f"ServingConfig.kv_cache_dtype {r.kv_cache_dtype!r} is not "
                f"supported — '' (store in the model dtype) or 'int8' "
                f"(quantized pool + scales)")
        if r.prefix_cache:
            raise NotImplementedError(
                f"ServingConfig.prefix_cache=True: the shared-prefix cache "
                f"is not ported yet ({_ROADMAP})")
        r.prefix_cache = False
        r.block_size = r.block_size or SERVING_BLOCK_SIZE
        r.max_batch = r.max_batch or SERVING_MAX_BATCH
        r.num_blocks = r.num_blocks or SERVING_NUM_BLOCKS
        r.prefill_token_budget = (r.prefill_token_budget
                                  or SERVING_PREFILL_TOKEN_BUDGET)
        if r.preemption is None:
            r.preemption = SERVING_PREEMPTION
        if r.prefill_buckets is None:
            r.prefill_buckets = _default_buckets(r.max_seq_len)
        else:
            r.prefill_buckets = tuple(sorted({int(b)
                                              for b in r.prefill_buckets}))
            if not r.prefill_buckets:
                raise ValueError("prefill_buckets is empty")
            if r.prefill_buckets[-1] > r.max_seq_len:
                raise ValueError(f"prefill_buckets {r.prefill_buckets} "
                                 f"exceed max_seq_len {r.max_seq_len}")
            if r.prefill_buckets[-1] < r.max_seq_len:
                r.prefill_buckets += (r.max_seq_len,)
        return r


class ServingEngine:
    """Continuous-batching runtime over one ``LlamaForCausalLM``. Runs on
    ``device`` (default: the model's device); a CUDA device without a card
    raises."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None):
        cfg = model.config
        self.config = c = (config or ServingConfig()).resolve()
        self.device = entry_device(model.device, device, "ServingEngine")
        if c.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"ServingConfig.max_seq_len {c.max_seq_len} exceeds the "
                f"model's max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        self._cfg = cfg
        self.spec = KVCacheSpec.from_config(cfg, page_size=c.block_size,
                                            cache_dtype=c.kv_cache_dtype)
        pps = self.spec.pages_per_seq(c.max_seq_len)
        self.pool = BlockPool(self.spec, c.max_seq_len,
                              c.num_blocks or (c.max_batch * pps + 1),
                              c.max_batch, optimistic=c.preemption,
                              device=self.device)
        self.scheduler = Scheduler(self.pool, c.prefill_token_budget)
        self.weights = fused_weights_from_llama(model, quantize=c.quantize)
        self._embed = model.model.embed_tokens.weight
        self._final_norm = model.model.norm.weight
        # the f32 tail multiplies by an f32 head (the embedding matrix when
        # tied): convert it once
        self._head = model.head_weight.detach().float().t()
        self._cos, self._sin = build_rope_cache(
            c.max_seq_len, cfg.head_dim, cfg.rope_theta, device=self.device)
        self._active: Dict[int, Request] = {}
        # admitted, with (chunked) prefill still in flight: masked out of
        # the decode batch until the last chunk lands
        self._prefilling: Dict[int, Request] = {}
        self._last_prefill_tok: Dict[int, int] = {}
        self._stalled: set = set()
        self._ttft_ms: List[float] = []
        self._decode_ms: List[float] = []
        self._draining = False
        self.iterations = 0
        self.preemptions = 0
        self.decode_stalls = 0
        self.prefill_chunks = 0
        self.decode_steps = 0

    # -- step families --------------------------------------------------------
    def _geometry(self):
        cfg = self._cfg
        return (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.rms_norm_eps)

    def _tail(self, h_last):
        """Greedy token (host int) and f32 logits of hidden rows [N, D]."""
        logits = lm_head_tail(h_last, self._final_norm, self._head,
                              self._cfg.rms_norm_eps)
        return logits.argmax(dim=-1), logits

    def _scatter(self, k, v, pos, block_row):
        """Write k/v ``[L, n, kvh, dh]`` at absolute positions ``pos [n]``
        into a slot's blocks, in place. A quantized pool stores
        ``quantize_kv`` of them, value and scale at the same coordinates
        (``_scatter_kv``, ``paddle_tpu/serving/engine.py:128-150``)."""
        page, pool = self.config.block_size, self.pool
        phys = block_row[pos // page]
        slot = pos % page
        for pages, scales, vals in ((pool.k_pages, pool.k_scales, k),
                                    (pool.v_pages, pool.v_scales, v)):
            vals = vals.transpose(1, 2)                  # [L, kvh, n, dh]
            if scales is None:
                pages[:, :, phys, slot] = vals.to(pages.dtype)
                continue
            qv, sc = quantize_kv(vals)                   # sc [L, kvh, n]
            pages[:, :, phys, slot] = qv
            # block-major scales: the indexed shape is [n, L, kvh]
            scales[:, phys, :, slot] = sc.permute(2, 0, 1)

    def _gather(self, pos, block_row):
        """The cached k/v at absolute positions ``pos [n]`` of a slot's
        blocks as ``[L, n, kvh, dh]`` in the compute dtype, dequantized
        from a quantized pool (``engine.py:838-855``)."""
        page, pool = self.config.block_size, self.pool
        phys, slot = block_row[pos // page], pos % page
        out = []
        for pages, scales in ((pool.k_pages, pool.k_scales),
                              (pool.v_pages, pool.v_scales)):
            g = pages[:, :, phys, slot]                  # [L, kvh, n, dh]
            if scales is not None:
                g = dequantize_kv(g, scales[:, phys, :, slot].permute(1, 2, 0),
                                  self.spec.torch_dtype)
            out.append(g.transpose(1, 2))
        return out

    @torch.inference_mode()
    def _prefill(self, ids: np.ndarray, chunk_len: int, offset: int,
                 block_row: np.ndarray):
        """One prefill chunk: tokens ``[offset, offset + chunk_len)`` of a
        sequence whose first ``offset`` positions are already in its
        blocks. ``ids`` is the chunk padded to its bucket ``S``; pad rows
        are causally downstream of the real ones and are never stored.
        ``offset == 0`` is the one-shot prefill (no carried KV). Returns
        the greedy token after the chunk's last real position (host int)
        and its f32 logits ``[1, vocab]``."""
        hq, hk, eps = self._geometry()
        dev, S = self.device, ids.shape[0]
        ids_t = torch.from_numpy(ids).to(dev, torch.long)
        row = torch.from_numpy(block_row).to(dev, torch.long)
        x = self._embed[ids_t][None]                      # [1, S, D]
        pos_abs = torch.clamp(offset + torch.arange(S, device=dev),
                              max=self.config.max_seq_len - 1)
        cos, sin = self._cos[pos_abs], self._sin[pos_abs]
        # scratch dense cache of the carried prefix plus this chunk's bucket
        ck, cv = self.spec.alloc_dense(1, offset + S, dev)
        if offset:
            ck[:, 0, :offset], cv[:, 0, :offset] = self._gather(
                torch.arange(offset, device=dev), row)
        h, ck, cv = fused_multi_transformer(
            x, self.weights, ck, cv, offset, cos, sin, num_heads=hq,
            num_kv_heads=hk, epsilon=eps)
        tok, logits = self._tail(h[0, chunk_len - 1:chunk_len])
        new = slice(offset, offset + chunk_len)
        self._scatter(ck[:, 0, new], cv[:, 0, new],
                      torch.arange(offset, offset + chunk_len, device=dev),
                      row)
        return int(tok[0]), logits

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, table: torch.Tensor,
                lens: torch.Tensor) -> np.ndarray:
        """One decode step over all ``max_batch`` rows; returns the greedy
        tokens (host)."""
        hq, hk, eps = self._geometry()
        tok_t = torch.from_numpy(tokens).to(self.device, torch.long)
        x = self._embed[tok_t][:, None]                   # [B, 1, D]
        pos = torch.clamp(lens.long(), max=self.config.max_seq_len - 1)
        cos, sin = self._cos[pos][:, None], self._sin[pos][:, None]
        pool = self.pool
        h = fused_multi_transformer_paged_ragged(
            x, self.weights, pool.k_pages, pool.v_pages, table, lens, cos,
            sin, num_heads=hq, num_kv_heads=hk, epsilon=eps,
            k_scales=pool.k_scales, v_scales=pool.v_scales)[0]
        tok, _ = self._tail(h[:, -1])
        return tok.cpu().numpy()

    # -- submission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, on_token=None,
               rid=None) -> Request:
        """Queue one request and return its handle. Raises ``ValueError``
        when the request can never fit."""
        if self._draining:
            raise RuntimeError("serving: engine is draining — admission is "
                               "stopped")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("serving: empty prompt")
        if max_new_tokens < 1:
            raise ValueError("serving: max_new_tokens must be >= 1")
        if prompt.min() < 0 or prompt.max() >= self._cfg.vocab_size:
            raise ValueError(f"serving: prompt token ids must lie in "
                             f"[0, {self._cfg.vocab_size})")
        rid = f"req-{next(_rid_counter)}" if rid is None else rid
        check_request_fits(prompt.shape[0], max_new_tokens,
                           self.config.max_seq_len,
                           "ServingConfig.max_seq_len", request=rid)
        need = self.spec.blocks_for(prompt.shape[0] + max_new_tokens)
        if need > self.pool.usable_blocks:
            raise ValueError(
                f"request {rid!r} needs {need} KV blocks but the pool has "
                f"only {self.pool.usable_blocks} — raise "
                f"ServingConfig.num_blocks or shrink the request")
        req = Request(rid, prompt, max_new_tokens, eos_token_id, on_token)
        self.scheduler.submit(req)
        return req

    # -- engine loop ----------------------------------------------------------
    def step(self) -> bool:
        """One iteration: admit, run up to ``prefill_token_budget`` tokens
        of prefill, then one decode step over the active slots. Returns
        True while work remains."""
        self.iterations += 1
        if not self._draining:
            admitted = self.scheduler.schedule()
        elif self.scheduler.has_preempted_queued():
            admitted = self.scheduler.schedule(only_preempted=True)
        else:
            admitted = []
        for req, slot in admitted:
            self._prefilling[slot] = req
        if self._prefilling:
            self._prefill_iteration()
        if self._active:
            self._decode_iteration()
        return (bool(self._active) or bool(self._prefilling)
                or self.scheduler.has_queued())

    def run_until_complete(self, max_iterations: int = 1_000_000) -> None:
        while (self.scheduler.has_queued() or self._active
               or self._prefilling):
            if max_iterations <= 0:
                raise RuntimeError("serving: run_until_complete exceeded "
                                   "max_iterations")
            max_iterations -= 1
            admitted_before = self.scheduler.admitted
            idle = not self._active and not self._prefilling
            self.step()
            if idle and not self._active and not self._prefilling and \
                    self.scheduler.admitted == admitted_before and \
                    self.scheduler.has_queued():
                raise RuntimeError("serving: scheduler deadlock — queued "
                                   "request cannot be admitted into an "
                                   "empty pool")

    def drain(self, max_iterations: int = 1_000_000) -> dict:
        """Graceful shutdown: stop admission, cancel never-admitted queued
        requests, finish every in-flight one, then check that the pool is
        fully reclaimed. Returns the final stats."""
        self._draining = True
        try:
            self.scheduler.cancel_queued()
            while (self._active or self._prefilling
                   or self.scheduler.has_preempted_queued()):
                if max_iterations <= 0:
                    raise RuntimeError("serving: drain exceeded "
                                       "max_iterations")
                max_iterations -= 1
                self.step()
        finally:
            self._draining = False
        p = self.pool.stats()
        if p["blocks_in_use"] or p["reserved_blocks"] \
                or p["free_blocks"] != p["num_blocks"]:
            raise RuntimeError(
                f"serving: drain completed but the pool did not reclaim "
                f"fully — {p['blocks_in_use']} blocks in use, "
                f"{p['reserved_blocks']} reserved, {p['free_blocks']}/"
                f"{p['num_blocks']} free")
        return self.stats()

    def stream(self, req: Request):
        """Yield ``req``'s tokens as they are produced, stepping the
        engine in between."""
        seen = 0
        while True:
            while seen < len(req.tokens):
                yield req.tokens[seen]
                seen += 1
            if req.finished:
                return
            self.step()

    def generate_batch(self, prompts: Sequence, max_new_tokens: int = 32,
                       eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Submit every prompt, run to completion, return the generated
        token lists in submission order."""
        reqs = [self.submit(p, max_new_tokens, eos_token_id=eos_token_id)
                for p in prompts]
        self.run_until_complete()
        return [r.tokens for r in reqs]

    # -- internals ------------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for S in self.config.prefill_buckets:
            if S >= n:
                return S
        return self.config.prefill_buckets[-1]

    def _prefill_iteration(self) -> None:
        """Up to ``prefill_token_budget`` tokens of prefill, oldest
        admission first, one bucket-shaped chunk per request."""
        budget = self.config.prefill_token_budget
        for slot, req in list(self._prefilling.items()):
            if budget <= 0:
                break
            seq, offset = req._prefill_seq, req._prefill_pos
            chunk = min(len(seq) - offset, budget)
            budget -= chunk
            ids = np.zeros((self._bucket_for(chunk),), np.int32)
            ids[:chunk] = seq[offset:offset + chunk]
            tok, _ = self._prefill(ids, chunk, offset, self.pool.table[slot])
            req.prefill_chunks += 1
            self.prefill_chunks += 1
            req._prefill_pos += chunk
            self.pool.lens[slot] = req._prefill_pos
            if req._prefill_pos >= len(seq):
                # last chunk: into the decode batch; a resumed request
                # already emitted this token before it was preempted
                del self._prefilling[slot]
                self._active[slot] = req
                if not req.tokens:
                    self._emit(req, tok)

    def _pick_victim(self) -> Optional[int]:
        """The most recently admitted running request."""
        best_slot, best_seq = None, -1
        for group in (self._active, self._prefilling):
            for slot, req in group.items():
                if req.admit_seq is not None and req.admit_seq > best_seq:
                    best_slot, best_seq = slot, req.admit_seq
        return best_slot

    def _preempt(self, slot: int) -> None:
        """Evict one running request: release its blocks and requeue it at
        the head; re-admission recomputes its prefix through prefill."""
        req = self._active.pop(slot, None) or self._prefilling.pop(slot)
        self.pool.release(slot)
        self.scheduler.requeue_front(req)
        self.preemptions += 1

    def _grow_or_preempt(self, slot: int) -> bool:
        """Bind the block the slot's next token lands in, preempting the
        most recently admitted request while the pool is exhausted. When
        the slot is itself that request it stalls for this iteration
        (keeps its blocks) instead of preempting itself. Returns False
        when the slot does not decode this iteration."""
        while True:
            try:
                self.pool.ensure_decode_block(slot)
                return True
            except BlockPoolExhausted:
                victim = self._pick_victim()
                if victim == slot:
                    self.decode_stalls += 1
                    self._stalled.add(slot)
                    return False
                self._preempt(victim)

    def _decode_iteration(self) -> None:
        pool, c = self.pool, self.config
        self._stalled.clear()
        for slot, req in list(self._active.items()):
            if self._active.get(slot) is req:   # not preempted meanwhile
                self._grow_or_preempt(slot)
        ready = {s: r for s, r in self._active.items()
                 if s not in self._stalled}
        if not ready:
            return
        tokens = np.zeros((c.max_batch,), np.int32)
        for slot, req in ready.items():
            tokens[slot] = req.tokens[-1]
        # rows mid-prefill or stalled must not commit into their blocks
        masked = bool(self._prefilling or self._stalled)
        table, lens = pool.device_tables(ready if masked else None)
        toks = self._decode(tokens, table, lens)
        self.decode_steps += 1
        for slot, req in ready.items():
            pool.lens[slot] += 1               # the input token was committed
            self._emit(req, int(toks[slot]))

    def _emit(self, req: Request, tok: int) -> None:
        is_last = (len(req.tokens) + 1 >= req.max_new_tokens
                   or (req.eos_token_id is not None
                       and tok == req.eos_token_id))
        req._emit(tok, is_last)
        if is_last:
            self.pool.release(req.slot)
            self._active.pop(req.slot, None)
            self.scheduler.note_finished()
            self._ttft_ms.append(req.ttft_ms)
            if req.decode_ms_per_token is not None:
                self._decode_ms.append(req.decode_ms_per_token)

    def stats(self) -> dict:
        """A fresh snapshot: latency means, pool and scheduler counters, and
        the kernels' launch counts (module-wide since last set to 0)."""
        mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
        return {
            "iterations": self.iterations,
            "pool": self.pool.stats(),
            "scheduler": self.scheduler.stats(),
            "latency": {"finished": len(self._ttft_ms),
                        "mean_ttft_ms": mean(self._ttft_ms),
                        "mean_decode_ms_per_token": mean(self._decode_ms)},
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "preemptions": self.preemptions,
            "decode_stalls": self.decode_stalls,
            "prefill_chunks": self.prefill_chunks,
            "decode_steps": self.decode_steps,
            "kernel_launches": {
                "flash_attention": _flash_cuda.launches,
                "paged_attention": _paged_cuda.launches,
                "paged_attention_int8": _paged_cuda.int8_launches,
                "int8_matmul": _wo_cuda.launches,
                "int4_matmul": _wo_cuda.int4_launches},
            "mode": {"preemption": self.config.preemption,
                     "prefix_cache": self.config.prefix_cache,
                     "quantize": self.config.quantize,
                     "kv_cache_dtype": self.spec.storage_dtype},
        }
