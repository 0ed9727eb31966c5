"""Continuous-batching serving engine for causal LMs (the counterpart of
``paddle_tpu/serving/engine.py``).

One ``ServingEngine`` owns a model's stacked fused weights, a KV
:class:`~paddle_tpu_torch.serving.block_pool.BlockPool` and an FCFS
:class:`~paddle_tpu_torch.serving.scheduler.Scheduler`, and drives an
iteration-level loop: every :meth:`step` admits queued requests, runs up
to ``prefill_token_budget`` tokens of (chunked) prefill, then one decode
step over every active slot.

Step families, all greedy:

* ``prefill``: a whole cold prompt at offset 0, padded to a bucket ``S``,
  through ``fused_multi_transformer`` over an ``S``-long scratch cache
  (the flash kernel), then the prompt's k/v scattered into its blocks;
* ``prefill_carry``: one chunk at a carried offset (chunked prefill,
  preemption recompute and every prefix-cache hit) — the cached prefix is
  gathered from the pool into the scratch cache first, from shared blocks
  as from private ones;
* ``decode``: ``max_batch`` rows, one token each, through
  ``fused_multi_transformer_paged_ragged`` (the paged kernel); idle rows
  write into the null block;
* speculative mode (``ServingConfig(speculative=(draft_model, k))``):
  ``k + 1`` drafter decode steps over its own page buffers, which ride
  the verifier's block ids (the last step only commits the last draft's
  k/v), then one ``verify`` step over the ``[max_batch, k + 1]`` window
  through ``fused_multi_transformer_paged_ragged_verify`` (the paged
  kernel over ``max_batch * (k + 1)`` folded rows). The longest drafted
  prefix that agrees with the verifier's greedy choices commits, plus the
  verifier's own next token, so the stream equals plain greedy decoding
  token for token; a rejected draft is undone by truncating ``lens`` on
  the host. Every prefill chunk runs on the drafter too.

The shared-prefix cache (``prefix_cache``, on by default under
preemption) maps cached full prompt blocks into a new request's table, so
only the uncached tail is prefilled.

Fault isolation: every step yields a health value per row (max |logit|,
f32); a non-finite one (the NaN sentinel, on by default) quarantines only
that request — ``status="error"``, its blocks reclaimed — and the others
keep serving. A prefill that raises and a block bind that fails
mid-decode are contained the same way; ``Request.cancel()`` and
``submit(deadline_ms=)`` are reaped at the iteration boundary, before any
device work. The fault points of ``core/faults.py`` drive these paths in
tests.

PyTorch runs eagerly, so there is no trace cache or bucket warmup; the
buckets only round the prefill length. Pool writes are in place.

Telemetry: the engine's counters, gauges and latency histograms
(``serving.ttft_ms``, ``serving.tpot_ms``, ``serving.step_ms``) live in
the metrics registry of ``core/metrics.py`` under ``metrics_labels``
(``engine=<n>``), shared by its pool and scheduler; every step appends
one record to ``flight_recorder`` (``core/observatory.py``), which dumps a
postmortem on a quarantine, a contained fault, a drain leak and in
``evacuate``; requests record their lifecycle events. Telemetry never
steers: every count the engine branches on is a plain attribute, and the
step's health extrema come from the host array the step copies anyway.
``share_weights_with`` builds a replica of another engine over the same
model and config that reads that engine's fused weights and keeps only
its own pool (a ``Fleet``'s replicas).

Quantized modes, in any combination: ``quantize`` (False, True = "int8",
"int8", "int4") stores the decoder's four weight stacks weight-only
quantized, and every product goes through the weight-only GEMM;
``kv_cache_dtype="int8"`` stores the pool as int8 pages with per-token
scales, quantized at every pool write and dequantized by the paged kernel
and by the chunked-prefill carry.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import faults, metrics
from ..core.device import entry_device
from ..core.observatory import FlightRecorder
from ..incubate.nn.functional.fused_transformer import (
    FusedTransformerWeights, fused_multi_transformer,
    fused_multi_transformer_paged_ragged,
    fused_multi_transformer_paged_ragged_verify, fused_weights_from_llama)
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
SERVING_PREFIX_CACHE = True     # only under preemption (optimistic pool)
SERVING_KV_CACHE_DTYPE = ""     # "" = store the pool in the model dtype
SERVING_NAN_SENTINEL = True

_rid_counter = itertools.count()
_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


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
    quantization; ``kv_cache_dtype``: "" (the model dtype) or "int8";
    ``speculative``: None or ``(draft_model, k)``, a causal LM that
    proposes ``k`` greedy tokens an iteration for the engine's model to
    verify in one step. ``interpret`` and ``donate`` have no counterpart in
    eager PyTorch (no interpreter, writes are in place) and are ignored."""

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

    @property
    def speculative_k(self) -> int:
        """Drafted tokens an iteration (0: speculative mode off)."""
        return int(self.speculative[1]) if self.speculative else 0

    def resolve(self, verifier_cfg=None) -> "ServingConfig":
        """A resolved copy. ``verifier_cfg`` (the engine passes its model's
        config) turns on the drafter / verifier cross-checks."""
        r = dataclasses.replace(self)
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
        r.block_size = r.block_size or SERVING_BLOCK_SIZE
        r.max_batch = r.max_batch or SERVING_MAX_BATCH
        r.num_blocks = r.num_blocks or SERVING_NUM_BLOCKS
        r.prefill_token_budget = (r.prefill_token_budget
                                  or SERVING_PREFILL_TOKEN_BUDGET)
        if r.preemption is None:
            r.preemption = SERVING_PREEMPTION
        if r.prefix_cache is None:
            r.prefix_cache = SERVING_PREFIX_CACHE
        # worst-case reservation cannot describe shared blocks: the prefix
        # cache rides on optimistic admission only
        r.prefix_cache = bool(r.prefix_cache and r.preemption)
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
        if r.speculative is not None:
            r.speculative = self._resolve_speculative(r, verifier_cfg)
        return r

    @staticmethod
    def _resolve_speculative(r: "ServingConfig", verifier_cfg) -> tuple:
        """Check ``speculative=(draft_model, k)``; each refusal names the
        field and the limit (the JAX messages, ``engine.py:285-332``)."""
        try:
            draft_model, k = r.speculative
        except (TypeError, ValueError):
            raise ValueError(
                f"ServingConfig.speculative must be a (draft_model, k) "
                f"pair, got {r.speculative!r}") from None
        k = int(k)
        if k < 1:
            raise ValueError(
                f"ServingConfig.speculative k={k} — the drafter must "
                f"propose at least one token per iteration (k >= 1); "
                f"for plain decode pass speculative=None")
        if k + 1 > r.max_seq_len:
            raise ValueError(
                f"ServingConfig.speculative k={k} makes the verify "
                f"window k+1={k + 1} tokens, which exceeds max_seq_len "
                f"{r.max_seq_len} — no request could ever hold one "
                f"window; lower k or raise max_seq_len")
        if k + 1 > r.prefill_token_budget:
            raise ValueError(
                f"ServingConfig.speculative k={k} needs a verify window "
                f"of k+1={k + 1} tokens per iteration, which exceeds "
                f"prefill_token_budget {r.prefill_token_budget} — the "
                f"budget paces ALL per-iteration token work so chunked "
                f"prefill and the verify bucket interleave fairly; "
                f"lower k or raise the budget")
        dcfg = getattr(draft_model, "config", None)
        if dcfg is None:
            raise ValueError(
                "ServingConfig.speculative draft_model has no .config — "
                "pass a causal LM (LlamaForCausalLM-shaped), not weights")
        if dcfg.max_position_embeddings < r.max_seq_len:
            raise ValueError(
                f"ServingConfig.speculative drafter only supports "
                f"max_position_embeddings {dcfg.max_position_embeddings} "
                f"but max_seq_len is {r.max_seq_len} — the drafter must "
                f"cover every position the verifier can reach")
        if verifier_cfg is not None and \
                dcfg.vocab_size != verifier_cfg.vocab_size:
            raise ValueError(
                f"ServingConfig.speculative drafter vocab_size "
                f"{dcfg.vocab_size} != verifier vocab_size "
                f"{verifier_cfg.vocab_size} — draft and verify must "
                f"speak one tokenizer for token ids to be comparable")
        return (draft_model, k)


@dataclass
class _Stack:
    """One model the engine runs: the verifier, or the speculative drafter
    whose page buffers ride the same block ids. ``kv`` is ``(k_pages,
    v_pages, k_scales, v_scales)``; the scales are None on a bf16 or f32
    pool."""

    cfg: object
    spec: KVCacheSpec
    weights: FusedTransformerWeights
    embed: torch.Tensor
    final_norm: torch.Tensor
    head: torch.Tensor          # [D, V] f32
    cos: torch.Tensor
    sin: torch.Tensor
    kv: tuple

    @classmethod
    def of(cls, model, spec, quantize, max_seq_len, device, kv):
        cfg = model.config
        cos, sin = build_rope_cache(max_seq_len, cfg.head_dim,
                                    cfg.rope_theta, device=device)
        return cls(cfg, spec,
                   fused_weights_from_llama(model, quantize=quantize),
                   model.model.embed_tokens.weight, model.model.norm.weight,
                   # the f32 tail multiplies by an f32 head (the embedding
                   # matrix when tied): convert it once
                   model.head_weight.detach().float().t(), cos, sin, kv)

    def run(self, fn, x, *args, **kw):
        """``fn`` over this stack's weights and pool buffers."""
        c = self.cfg
        k_pages, v_pages, k_scales, v_scales = self.kv
        return fn(x, self.weights, k_pages, v_pages, *args,
                  num_heads=c.num_attention_heads,
                  num_kv_heads=c.num_key_value_heads,
                  epsilon=c.rms_norm_eps, k_scales=k_scales,
                  v_scales=v_scales, **kw)

    def tail(self, h):
        """f32 logits ``[N, V]`` of hidden rows ``[N, D]``."""
        return lm_head_tail(h, self.final_norm, self.head,
                            self.cfg.rms_norm_eps)


class ServingEngine:
    """Continuous-batching runtime over one ``LlamaForCausalLM``. Runs on
    ``device`` (default: the model's device); a CUDA device without a card
    raises. ``share_weights_with``: an engine over the same model and
    config whose fused weights (and drafter's) this one reads; its page
    buffers stay its own."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 device=None, share_weights_with=None):
        cfg = model.config
        self.config = c = (config or ServingConfig()).resolve(
            verifier_cfg=cfg)
        self.device = entry_device(model.device, device, "ServingEngine")
        if c.max_seq_len > cfg.max_position_embeddings:
            raise ValueError(
                f"ServingConfig.max_seq_len {c.max_seq_len} exceeds the "
                f"model's max_position_embeddings "
                f"{cfg.max_position_embeddings}")
        self._cfg = cfg
        self.spec = KVCacheSpec.from_config(cfg, page_size=c.block_size,
                                            cache_dtype=c.kv_cache_dtype)
        self._spec_k = c.speculative_k
        draft = c.speculative[0] if self._spec_k else None
        if draft is not None and draft.device != self.device:
            raise ValueError(f"ServingConfig.speculative: the drafter lives "
                             f"on {draft.device}, the engine on "
                             f"{self.device}")
        draft_spec = (KVCacheSpec.from_config(
            draft.config, page_size=c.block_size,
            cache_dtype=c.kv_cache_dtype) if draft is not None else None)
        src = share_weights_with
        if src is not None and (src._model is not model or src.config != c
                                or src.device != self.device):
            raise ValueError("ServingEngine(share_weights_with=): the other "
                             "engine must serve the same model with the same "
                             "config on the same device")
        self._model = model
        pps = self.spec.pages_per_seq(c.max_seq_len)
        # one label per engine: the replica key of the metrics registry,
        # shared by its pool and scheduler
        self.metrics_labels = lbl = {
            "engine": str(metrics.next_instance_id("engine"))}
        self.pool = p = BlockPool(
            self.spec, c.max_seq_len, c.num_blocks or (c.max_batch * pps + 1),
            c.max_batch, optimistic=c.preemption,
            prefix_cache=c.prefix_cache, draft_spec=draft_spec,
            device=self.device, metrics_labels=lbl)
        self.scheduler = Scheduler(self.pool, c.prefill_token_budget,
                                   metrics_labels=lbl)
        kv = (p.k_pages, p.v_pages, p.k_scales, p.v_scales)
        self._target = (
            dataclasses.replace(src._target, kv=kv) if src is not None else
            _Stack.of(model, self.spec, c.quantize, c.max_seq_len,
                      self.device, kv))
        self.weights = self._target.weights
        self._drafter = None
        if draft is not None:
            draft_kv = (p.draft_k_pages, p.draft_v_pages, p.draft_k_scales,
                        p.draft_v_scales)
            # a self-drafting engine reads the verifier's weights and keeps
            # only its page buffers apart
            self._drafter = (
                dataclasses.replace(self._target, kv=draft_kv)
                if draft is model else
                dataclasses.replace(src._drafter, kv=draft_kv)
                if src is not None else
                _Stack.of(draft, draft_spec, c.quantize, c.max_seq_len,
                          self.device, draft_kv))
        self._sentinel = SERVING_NAN_SENTINEL
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
        self.prefill_carry_chunks = 0
        self.decode_steps = 0
        self.draft_steps = 0
        self.verify_steps = 0
        self.peak_running = 0
        # containment: the deadlock detector branches on contained_events
        self.contained_events = 0
        self.quarantined_requests = 0
        self.nan_events = 0
        self.callback_errors = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_rollback = 0
        self.spec_committed = 0
        self._init_telemetry(lbl)
        _ENGINES.add(self)

    def _init_telemetry(self, lbl: Dict[str, str]) -> None:
        """The registry instruments (each a mirror of a plain count, or a
        histogram), the flight recorder and its per-step fields."""
        mc = lambda name, doc: metrics.counter(  # noqa: E731
            name, doc=doc, owner=self, **lbl)
        mh = lambda name, doc, **kw: metrics.histogram(  # noqa: E731
            name, doc=doc, owner=self, **kw, **lbl)
        self._m_quarantined = mc(
            "serving.quarantined_requests",
            "Requests removed from the running batch abnormally (blocks "
            "reclaimed, slot drained).")
        self._m_contained = mc(
            "serving.contained_faults",
            "Faults contained at request granularity by the engine.")
        self._m_nan_events = mc(
            "serving.nan_events",
            "Non-finite health values caught by the NaN sentinel.")
        self._m_callback_errors = mc(
            "serving.callback_errors",
            "Exceptions raised by user on_token callbacks.")
        self._m_preemptions = mc(
            "serving.preemptions",
            "Requests evicted to free KV blocks (requeued + recomputed) — "
            "router load input.")
        self._m_prefill_chunks = mc(
            "serving.prefill_chunks",
            "Prefill chunk executions (one bucket-shaped call each).")
        self._m_decode_stalls = mc(
            "serving.decode_stalls",
            "Decode iterations a lowest-priority request yielded waiting "
            "for blocks — router load input.")
        self._m_peak_running = metrics.gauge(
            "serving.peak_running",
            doc="High-water mark of concurrently running requests.",
            owner=self, **lbl)
        self._m_ttft = mh("serving.ttft_ms",
                          "Time to first token, ms (normal completions).")
        self._m_tpot = mh(
            "serving.tpot_ms",
            "Decode ms per generated token (normal completions).")
        self._m_step_ms = mh(
            "serving.step_ms",
            "Engine iteration wall-clock, ms (admit + prefill + decode): "
            "the flight recorder's per-step timing.")
        for gname, fn, doc in (
                ("serving.active", lambda e: len(e._active),
                 "Requests in the decode batch right now."),
                ("serving.prefilling", lambda e: len(e._prefilling),
                 "Requests mid-(chunked-)prefill right now."),
                ("serving.iterations", lambda e: e.iterations,
                 "Engine iterations driven.")):
            metrics.gauge(gname, doc=doc, callback=fn, owner=self, **lbl)
        self._m_spec_drafted = self._m_spec_accepted = None
        self._m_spec_rollback = self._m_spec_accept_rate = None
        if self._spec_k:
            self._m_spec_drafted = mc(
                "serving.spec_drafted",
                "Tokens proposed by the drafter (k per request per "
                "speculative iteration).")
            self._m_spec_accepted = mc(
                "serving.spec_accepted",
                "Drafted tokens the verifier accepted (committed without "
                "re-decode; excludes bonus tokens).")
            self._m_spec_rollback = mc(
                "serving.spec_rollback_tokens",
                "Drafted tokens rejected at verification, rolled back by "
                "lens truncation.")
            self._m_spec_accept_rate = mh(
                "serving.spec_accept_rate",
                "Per-request per-iteration acceptance rate (accepted/k), "
                "linear 0..1 buckets.", buckets=metrics.RATIO_BUCKETS)
        self.flight_recorder = FlightRecorder(
            labels=lbl, name=f"engine{lbl['engine']}")
        self._last_quarantine: Optional[dict] = None
        self._last_decode_batch = 0
        self._last_prefill_tokens = 0
        self._health_min: Optional[float] = None
        self._health_max: Optional[float] = None
        self._nonfinite_health = 0

    # -- step families --------------------------------------------------------
    def _scatter(self, st: _Stack, k, v, pos, block_row):
        """Write k/v ``[L, n, kvh, dh]`` at absolute positions ``pos [n]``
        into a slot's blocks of ``st``'s pages, in place. A quantized pool
        stores ``quantize_kv`` of them, value and scale at the same
        coordinates (``_scatter_kv``, ``paddle_tpu/serving/engine.py:
        128-150``)."""
        page = self.config.block_size
        phys = block_row[pos // page]
        slot = pos % page
        k_pages, v_pages, k_scales, v_scales = st.kv
        for pages, scales, vals in ((k_pages, k_scales, k),
                                    (v_pages, v_scales, v)):
            vals = vals.transpose(1, 2)                  # [L, kvh, n, dh]
            if scales is None:
                pages[:, :, phys, slot] = vals.to(pages.dtype)
                continue
            qv, sc = quantize_kv(vals)                   # sc [L, kvh, n]
            pages[:, :, phys, slot] = qv
            # block-major scales: the indexed shape is [n, L, kvh]
            scales[:, phys, :, slot] = sc.permute(2, 0, 1)

    def _gather(self, st: _Stack, pos, block_row):
        """The cached k/v at absolute positions ``pos [n]`` of a slot's
        blocks of ``st``'s pages as ``[L, n, kvh, dh]`` in the compute
        dtype, dequantized from a quantized pool (``engine.py:838-855``);
        shared prefix blocks are read like private ones."""
        page = self.config.block_size
        phys, slot = block_row[pos // page], pos % page
        k_pages, v_pages, k_scales, v_scales = st.kv
        out = []
        for pages, scales in ((k_pages, k_scales), (v_pages, v_scales)):
            g = pages[:, :, phys, slot]                  # [L, kvh, n, dh]
            if scales is not None:
                g = dequantize_kv(g, scales[:, phys, :, slot].permute(1, 2, 0),
                                  st.spec.torch_dtype)
            out.append(g.transpose(1, 2))
        return out

    @torch.inference_mode()
    def _run_prefill(self, st: _Stack, ids: np.ndarray, chunk_len: int,
                     offset: int, block_row: np.ndarray):
        """One prefill chunk of ``st``: tokens ``[offset, offset +
        chunk_len)`` of a sequence whose first ``offset`` positions are
        already in its blocks. ``ids`` is the chunk padded to its bucket
        ``S``; pad rows are causally downstream of the real ones and are
        never stored. ``offset == 0`` is the one-shot prefill (no carried
        KV). Returns the greedy token after the chunk's last real position
        and its f32 logits ``[1, vocab]``, on the device."""
        c = st.cfg
        dev, S = self.device, ids.shape[0]
        ids_t = torch.from_numpy(ids).to(dev, torch.long)
        row = torch.from_numpy(block_row).to(dev, torch.long)
        x = st.embed[ids_t][None]                         # [1, S, D]
        pos_abs = torch.clamp(offset + torch.arange(S, device=dev),
                              max=self.config.max_seq_len - 1)
        # scratch dense cache of the carried prefix plus this chunk's bucket
        ck, cv = st.spec.alloc_dense(1, offset + S, dev)
        if offset:
            ck[:, 0, :offset], cv[:, 0, :offset] = self._gather(
                st, torch.arange(offset, device=dev), row)
        h, ck, cv = fused_multi_transformer(
            x, st.weights, ck, cv, offset, st.cos[pos_abs], st.sin[pos_abs],
            num_heads=c.num_attention_heads,
            num_kv_heads=c.num_key_value_heads, epsilon=c.rms_norm_eps)
        logits = st.tail(h[0, chunk_len - 1:chunk_len])
        new = slice(offset, offset + chunk_len)
        self._scatter(st, ck[:, 0, new], cv[:, 0, new],
                      torch.arange(offset, offset + chunk_len, device=dev),
                      row)
        return logits.argmax(dim=-1), logits

    def _prefill(self, ids: np.ndarray, chunk_len: int, offset: int,
                 block_row: np.ndarray):
        """The verifier's prefill chunk (see :meth:`_run_prefill`): the
        greedy token as a host int and the f32 logits ``[1, vocab]``."""
        tok, logits = self._run_prefill(self._target, ids, chunk_len, offset,
                                        block_row)
        return int(tok[0]), logits

    @torch.inference_mode()
    def _decode_step(self, st: _Stack, tok_t: torch.Tensor,
                     table: torch.Tensor, lens: torch.Tensor):
        """One decode step of ``st`` over all ``max_batch`` rows: the
        greedy tokens and the per-row health (max |logit|), on the
        device."""
        x = st.embed[tok_t][:, None]                      # [B, 1, D]
        pos = torch.clamp(lens.long(), max=self.config.max_seq_len - 1)
        h = st.run(fused_multi_transformer_paged_ragged, x, table, lens,
                   st.cos[pos][:, None], st.sin[pos][:, None])[0]
        logits = st.tail(h[:, -1])
        return logits.argmax(dim=-1), logits.abs().amax(dim=-1)

    @torch.inference_mode()
    def _decode(self, tokens: np.ndarray, table: torch.Tensor,
                lens: torch.Tensor):
        """One decode step of the verifier; the greedy tokens and the
        health values on the host (one transfer)."""
        tok_t = torch.from_numpy(tokens).to(self.device, torch.long)
        tok, health = self._decode_step(self._target, tok_t, table, lens)
        out = torch.stack([tok.float(), health]).cpu().numpy()
        return out[0].astype(np.int64), out[1]

    @torch.inference_mode()
    def _verify(self, win: torch.Tensor, table: torch.Tensor,
                lens: torch.Tensor, spans: torch.Tensor):
        """The verify step over the window ``win [B, S]``: the verifier's
        greedy token at every window position ``[B, S]`` and the per-row
        health (max |logit| over the window), on the device."""
        st = self._target
        B, S = win.shape
        x = st.embed[win]                                 # [B, S, D]
        pos = torch.clamp(lens.long()[:, None]
                          + torch.arange(S, device=self.device),
                          max=self.config.max_seq_len - 1)
        h = st.run(fused_multi_transformer_paged_ragged_verify, x, table,
                   lens, spans, st.cos[pos], st.sin[pos])[0]
        logits = st.tail(h.reshape(B * S, -1))
        return (logits.argmax(dim=-1).reshape(B, S),
                logits.abs().reshape(B, -1).amax(dim=-1))

    # -- submission -----------------------------------------------------------
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, on_token=None,
               rid=None, deadline_ms: Optional[float] = None) -> Request:
        """Queue one request and return its handle. Raises ``ValueError``
        when the request can never fit. ``deadline_ms`` is a wall-clock
        budget from submission: a request still queued past it ends
        ``status="timeout"``, a running one is quarantined at the next
        iteration boundary."""
        if self._draining:
            raise RuntimeError("serving: engine is draining — admission is "
                               "stopped")
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("serving: empty prompt")
        if max_new_tokens < 1:
            raise ValueError("serving: max_new_tokens must be >= 1")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError("serving: deadline_ms must be positive")
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
        req = Request(rid, prompt, max_new_tokens, eos_token_id, on_token,
                      deadline_ms=deadline_ms)
        self.scheduler.submit(req)
        return req

    # -- engine loop ----------------------------------------------------------
    def step(self) -> bool:
        """One iteration: admit, run up to ``prefill_token_budget`` tokens
        of prefill, then one decode (or draft and verify) step over the
        active slots. Returns True while work remains. Every iteration
        lands one flight-recorder record; one that quarantined or contained
        anything dumps a postmortem."""
        t0 = time.perf_counter()
        self._last_decode_batch = self._last_prefill_tokens = 0
        self._health_min = self._health_max = None
        self._nonfinite_health = 0
        quar0, cont0 = self.quarantined_requests, self._contained()
        self.iterations += 1
        if not self._draining:
            admitted = self.scheduler.schedule()
        elif self.scheduler.has_preempted_queued():
            admitted = self.scheduler.schedule(only_preempted=True)
        else:
            admitted = []
        for req, slot in admitted:
            self._prefilling[slot] = req
        running = len(self._active) + len(self._prefilling)
        self.peak_running = max(self.peak_running, running)
        self._m_peak_running.set_to_max(running)
        if self._prefilling:
            self._prefill_iteration()
        if self._active:
            if self._spec_k:
                self._speculative_iteration()
            else:
                self._decode_iteration()
        more = (bool(self._active) or bool(self._prefilling)
                or self.scheduler.has_queued())
        self._record_step(t0, quar0, cont0)
        return more

    def _note_health(self, values) -> None:
        """Fold one step's per-row health values (host floats) into the
        iteration's finite extrema and non-finite count."""
        for v in values:
            v = float(v)
            if not np.isfinite(v):
                self._nonfinite_health += 1
                continue
            if self._health_min is None or v < self._health_min:
                self._health_min = v
            if self._health_max is None or v > self._health_max:
                self._health_max = v

    def _record_step(self, t0: float, quar0: int, cont0: int) -> None:
        """Close an iteration: observe ``serving.step_ms``, append the
        flight-recorder record, and dump a postmortem when the iteration
        quarantined a request or contained a fault (with the ring off
        too: the dump still carries the registry slice and the ledger)."""
        step_ms = (time.perf_counter() - t0) * 1e3
        self._m_step_ms.observe(step_ms)
        fr = self.flight_recorder
        quar_d = self.quarantined_requests - quar0
        cont_d = self._contained() - cont0
        fr.record(iteration=self.iterations, step_ms=step_ms,
                  active=len(self._active),
                  prefilling=len(self._prefilling),
                  queued=self.scheduler.queue_depth,
                  decode_batch=self._last_decode_batch,
                  prefill_tokens=self._last_prefill_tokens,
                  stalls=len(self._stalled),
                  health_min=self._health_min,
                  health_max=self._health_max,
                  nonfinite_health=self._nonfinite_health,
                  preemptions_total=self.preemptions,
                  quarantined_total=self.quarantined_requests,
                  contained_total=self._contained(),
                  injected_total=faults.total_fired())
        if quar_d or cont_d:
            fr.dump("quarantine" if quar_d else "contained_fault",
                    iteration=self.iterations,
                    quarantined_this_step=quar_d,
                    contained_this_step=cont_d,
                    last_quarantine=self._last_quarantine)

    def _contained(self) -> int:
        return self.contained_events + self.scheduler.admission_faults

    def _note_contained(self) -> None:
        self.contained_events += 1
        self._m_contained.inc()

    def _note_nan(self) -> None:
        self.nan_events += 1
        self._m_nan_events.inc()
        self._note_contained()

    def run_until_complete(self, max_iterations: int = 1_000_000) -> None:
        while (self.scheduler.has_queued() or self._active
               or self._prefilling):
            if max_iterations <= 0:
                raise RuntimeError("serving: run_until_complete exceeded "
                                   "max_iterations")
            max_iterations -= 1
            admitted_before = self.scheduler.admitted
            contained_before = self._contained()
            idle = not self._active and not self._prefilling
            self.step()
            # an idle step that admitted nothing and contained no fault
            # while work is queued: the head can never fit
            if idle and not self._active and not self._prefilling and \
                    self.scheduler.admitted == admitted_before and \
                    self._contained() == contained_before and \
                    self.scheduler.has_queued():
                raise RuntimeError("serving: scheduler deadlock — queued "
                                   "request cannot be admitted into an "
                                   "empty pool")

    def drain(self, cancel_queued: bool = True,
              max_iterations: int = 1_000_000) -> dict:
        """Graceful shutdown: stop admission, finish every in-flight
        request, then check that the pool is fully reclaimed, cached
        blocks included. Never-admitted queued requests end
        ``status="cancelled"`` (``cancel_queued=False`` leaves them queued
        for a later restart). Returns the final stats."""
        self._draining = True
        try:
            if cancel_queued:
                self.scheduler.cancel_queued("engine draining")
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
            # the leak's step history, before the crash
            self.flight_recorder.dump(
                "drain_leak", blocks_in_use=p["blocks_in_use"],
                reserved_blocks=p["reserved_blocks"],
                free_blocks=p["free_blocks"], num_blocks=p["num_blocks"])
            raise RuntimeError(
                f"serving: drain completed but the pool did not reclaim "
                f"fully — {p['blocks_in_use']} blocks in use, "
                f"{p['reserved_blocks']} reserved, {p['free_blocks']}/"
                f"{p['num_blocks']} free")
        return self.stats()

    def prefix_chain_hits(self, keys) -> int:
        """Leading blocks of a prompt's chained key list (``BlockPool.
        _chain_keys``) cached in this engine's pool now. Read-only: no
        counter moves, the LRU order stays (a router's affinity probe)."""
        return self.pool.chain_hits(keys)

    def evacuate(self, reason: str = "replica_die") -> tuple:
        """Treat this engine as lost and hand back every live request for
        another engine to finish from ``resume_tokens``: returns
        ``(running, queued)``, the in-flight requests in admission order
        and the never-admitted queue in FCFS order, all still alive, each
        with a ``replica_die`` trace event naming the phase it was caught
        in. The postmortem (cause ``reason``) dumps first. The pool is not
        released (its device state is lost with the engine) and the engine
        stays draining, so a late ``submit`` raises."""
        self.flight_recorder.dump(
            "replica_die", cause=reason,
            inflight=len(self._active) + len(self._prefilling),
            queued=self.scheduler.queue_depth)
        pairs = sorted([("decoding", r) for r in self._active.values()]
                       + [("prefilling", r)
                          for r in self._prefilling.values()],
                       key=lambda p: -1 if p[1].admit_seq is None
                       else p[1].admit_seq)
        label = self.metrics_labels["engine"]
        for phase, req in pairs:
            req._trace("replica_die", phase=phase, engine=label)
        self._active.clear()
        self._prefilling.clear()
        self._last_prefill_tok.clear()
        self._stalled.clear()
        queued = self.scheduler.take_queue()
        for req in queued:
            req._trace("replica_die", phase="queued", engine=label)
        self._draining = True
        return [r for _, r in pairs], queued

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
        admission first, one bucket-shaped chunk per request; cancelled and
        expired requests are reaped first."""
        budget = self.config.prefill_token_budget
        for slot, req in list(self._prefilling.items()):
            if self._prefilling.get(slot) is not req:
                continue
            if budget <= 0:
                break
            if req._cancel_requested:
                self._quarantine(slot, "cancelled",
                                 "cancelled while running")
                continue
            if req.deadline_exceeded():
                self._quarantine(
                    slot, "timeout",
                    f"deadline {req.deadline_ms:g} ms expired during "
                    f"prefill ({req._prefill_pos} tokens prefilled)")
                continue
            total = len(req._prefill_seq)
            chunk = min(total - req._prefill_pos, budget)
            budget -= chunk
            if self._prefill_chunk(req, slot, chunk) \
                    and req._prefill_pos >= total:
                self._finish_prefill(req, slot)

    def _prefill_chunk(self, req: Request, slot: int, chunk: int) -> bool:
        """One prefill chunk of ``req`` on the verifier and, speculative,
        on the drafter (its token is ignored: a drafter out of step costs
        acceptance, never tokens). Returns False when the request was
        quarantined."""
        seq, offset = req._prefill_seq, req._prefill_pos
        ids = np.zeros((self._bucket_for(chunk),), np.int32)
        ids[:chunk] = seq[offset:offset + chunk]
        row = self.pool.table[slot]
        try:
            tok, logits = self._prefill(ids, chunk, offset, row)
            if self._drafter is not None:
                self._run_prefill(self._drafter, ids, chunk, offset, row)
            health = float(logits.abs().amax())
        except Exception as e:
            # this request's prefill failed: it ends, the others go on
            self._note_contained()
            self._quarantine(slot, "error",
                             f"prefill failed: {type(e).__name__}: {e}")
            return False
        if faults.fault_point("serving.prefill_nan") is not None:
            health = float("nan")
        if offset > 0 and \
                faults.fault_point("serving.chunk_prefill_nan") is not None:
            health = float("nan")
        self._last_prefill_tokens += chunk
        self._note_health((health,))
        req.prefill_chunks += 1
        self.prefill_chunks += 1
        self._m_prefill_chunks.inc()
        self.prefill_carry_chunks += offset > 0
        req._trace("prefill_chunk", offset=offset, tokens=chunk,
                   recompute=req.preemptions > 0)
        req._prefill_pos += chunk
        self.pool.lens[slot] = req._prefill_pos
        self._last_prefill_tok[slot] = tok
        if self._sentinel and not np.isfinite(health):
            self._note_nan()
            self._quarantine(slot, "error",
                             "non-finite logits at prefill (NaN sentinel)")
            return False
        return True

    def _finish_prefill(self, req: Request, slot: int) -> None:
        """Last chunk landed: publish the full prompt blocks to the prefix
        cache and move the request into the decode batch; a resumed
        request already emitted this token before it was preempted."""
        del self._prefilling[slot]
        self.pool.register_prefix(slot, req._prefill_seq)
        tok = self._last_prefill_tok.pop(slot)
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
        self._last_prefill_tok.pop(slot, None)
        self.pool.release(slot)
        req._trace("preempt", generated=len(req.tokens))
        self.scheduler.requeue_front(req)
        self.preemptions += 1
        self._m_preemptions.inc()

    def _grow_or_preempt(self, slot: int, span: int = 1) -> bool:
        """Bind the blocks of the slot's next ``span`` positions (span > 1:
        the verify window), preempting the most recently admitted request
        while the pool is exhausted. When the slot is itself that request
        it stalls for this iteration (keeps its blocks). A bind fault
        quarantines the slot. Returns False when the slot does not decode
        this iteration."""
        while True:
            try:
                self.pool.ensure_decode_span(slot, span)
                return True
            except BlockPoolExhausted as e:
                victim = self._pick_victim()
                if victim is None:
                    self._note_contained()
                    self._quarantine(slot, "error",
                                     f"KV pool exhausted with no "
                                     f"preemption victim: {e}")
                    return False
                if victim == slot:
                    self.decode_stalls += 1
                    self._m_decode_stalls.inc()
                    self._stalled.add(slot)
                    return False
                self._preempt(victim)
            except Exception as e:
                self._note_contained()
                self._quarantine(slot, "error",
                                 f"KV block bind failed mid-decode: "
                                 f"{type(e).__name__}: {e}")
                return False

    def _ready_slots(self, spec_span: bool = False):
        """The decode iteration's prologue: reap cancellations and deadlines
        (before device work, so a reaped slot's blocks are back this very
        iteration), then bind each survivor's next block — with
        ``spec_span``, every block its verify window writes, the span
        capped at the request's token budget. Returns ``(ready,
        spans)``."""
        self._stalled.clear()
        spans: Dict[int, int] = {}
        now = time.perf_counter()
        for slot, req in list(self._active.items()):
            if self._active.get(slot) is not req:
                continue            # preempted by an earlier slot's growth
            if req._cancel_requested:
                self._quarantine(slot, "cancelled",
                                 "cancelled while running")
                continue
            if req.deadline_exceeded(now):
                self._quarantine(
                    slot, "timeout",
                    f"deadline {req.deadline_ms:g} ms expired after "
                    f"{len(req.tokens)} generated token(s)")
                continue
            span = 1
            if spec_span:
                cap = req.prompt_len + req.max_new_tokens
                span = max(min(self._spec_k + 1,
                               cap - int(self.pool.lens[slot])), 1)
                spans[slot] = span
            self._grow_or_preempt(slot, span)
        ready = {s: r for s, r in self._active.items()
                 if s not in self._stalled}
        return ready, spans

    def _tables(self, ready):
        """Device tables of this iteration: rows mid-prefill or stalled
        are masked to the null block, so they commit nothing."""
        masked = bool(self._prefilling or self._stalled)
        return self.pool.device_tables(ready if masked else None)

    def _sentinel_trips(self, slot: int, health: float, what: str) -> bool:
        """Quarantine ``slot`` when its health value is not finite."""
        if not self._sentinel or np.isfinite(health):
            return False
        self._note_nan()
        self._quarantine(slot, "error",
                         f"non-finite logits in {what} iteration "
                         f"{self.iterations} (NaN sentinel)")
        return True

    def _decode_iteration(self) -> None:
        pool, c = self.pool, self.config
        ready, _ = self._ready_slots()
        if not ready:
            return
        tokens = np.zeros((c.max_batch,), np.int32)
        for slot, req in ready.items():
            tokens[slot] = req.tokens[-1]
        table, lens, _ = self._tables(ready)
        toks, healths = self._decode(tokens, table, lens)
        self.decode_steps += 1
        if faults.fault_point("serving.decode_nan") is not None:
            healths[min(ready)] = np.nan
        if self.spec.quantized and \
                faults.fault_point("serving.kv_quant_nan") is not None:
            healths[min(ready)] = np.nan
        self._last_decode_batch = len(ready)
        self._note_health(healths[s] for s in ready)
        for slot, req in ready.items():
            pool.lens[slot] += 1               # the input token was committed
            if self._sentinel_trips(slot, healths[slot], "decode"):
                continue
            req._trace("decode", iteration=self.iterations)
            self._emit(req, int(toks[slot]))

    def _speculative_iteration(self) -> None:
        """One draft / verify iteration: ``k + 1`` drafter decode steps
        (step ``i`` consumes window token ``i`` and commits the drafter's
        k/v at ``lens + i``, clamped to the request's budget; the last only
        commits the last draft; tokens stay on the device), one verify
        step over the ``[max_batch, k + 1]`` window, then the host accepts
        the longest drafted prefix equal to the verifier's choices plus
        the verifier's next token, through the gates of plain decode. A
        rejected draft rolls back by ``lens`` alone."""
        pool, c, k = self.pool, self.config, self._spec_k
        ready, span_by_slot = self._ready_slots(spec_span=True)
        if not ready:
            return
        dev = self.device
        tokens = np.zeros((c.max_batch,), np.int32)
        caps = np.ones((c.max_batch,), np.int64)
        spans = np.zeros((c.max_batch,), np.int32)
        for slot, req in ready.items():
            tokens[slot] = req.tokens[-1]
            caps[slot] = req.prompt_len + req.max_new_tokens
            spans[slot] = span_by_slot[slot]
        table, lens, lens_np = self._tables(ready)
        with torch.inference_mode():
            cur = torch.from_numpy(tokens).to(dev, torch.long)
            window = [cur]
            for i in range(k + 1):
                lens_i = torch.from_numpy(np.minimum(
                    lens_np + i, caps - 1).astype(np.int32)).to(dev)
                cur, _ = self._decode_step(self._drafter, cur, table, lens_i)
                self.draft_steps += 1
                if i < k:
                    window.append(cur)
            win = torch.stack(window, dim=1)              # [B, k + 1]
            if faults.fault_point("serving.draft_divergence") is not None:
                # column 0 is the last committed token, never scrambled
                win[:, 1:] = (win[:, 1:] + 7) % self._cfg.vocab_size
            vtok, health = self._verify(win, table, lens,
                                        torch.from_numpy(spans).to(dev))
            # one transfer: drafts, verifier tokens, health
            host = torch.cat([win.float(), vtok.float(), health[:, None]],
                             dim=1).cpu().numpy()
        self.verify_steps += 1
        draft_np = host[:, :k + 1].astype(np.int64)
        v_np = host[:, k + 1:2 * k + 2].astype(np.int64)
        healths = host[:, -1].copy()
        if faults.fault_point("serving.verify_nan") is not None:
            healths[min(ready)] = np.nan
        self._last_decode_batch = len(ready)
        self._note_health(healths[s] for s in ready)
        for slot, req in ready.items():
            if self._sentinel_trips(slot, healths[slot], "speculative verify"):
                continue
            d, v = draft_np[slot], v_np[slot]
            a = 0            # the drafts that match the verifier's choices
            while a < k and d[a + 1] == v[a]:
                a += 1
            req._trace("draft", iteration=self.iterations, drafted=k)
            req._trace("verify", span=int(spans[slot]))
            acc_ev = req._trace("accept", accepted=a, agreed=a,
                                bonus=int(v[a]))
            emitted = 0
            for tok in [int(d[i + 1]) for i in range(a)] + [int(v[a])]:
                emitted += 1
                self._emit(req, tok)
                if req.finished:
                    break
            # an agreed draft cut off by eos or max_new_tokens is a
            # rollback, not an accept
            accepted = min(emitted, a)
            if acc_ev is not None:
                # the lane event agrees with the counters: accepted is
                # what committed, agreed the verifier-matched prefix
                acc_ev["accepted"] = accepted
                acc_ev["emitted"] = emitted
            req.spec_drafted += k
            req.spec_accepted += accepted
            self.spec_drafted += k
            self.spec_accepted += accepted
            self.spec_rollback += k - accepted
            self.spec_committed += emitted
            self._m_spec_drafted.inc(k)
            self._m_spec_accepted.inc(accepted)
            self._m_spec_rollback.inc(k - accepted)
            self._m_spec_accept_rate.observe(accepted / k)
            if not req.finished:
                # lens .. lens + emitted - 1 now hold the input token and
                # the accepted drafts; the rest of the window rolls back
                pool.lens[slot] += emitted

    def _emit(self, req: Request, tok: int) -> None:
        is_last = (len(req.tokens) + 1 >= req.max_new_tokens
                   or (req.eos_token_id is not None
                       and tok == req.eos_token_id))
        before = len(req.callback_errors)
        req._emit(tok, is_last)
        raised = len(req.callback_errors) - before
        self.callback_errors += raised
        self._m_callback_errors.inc(raised)
        if is_last:
            self._finish(req)

    def _quarantine(self, slot: int, status: str, error: str) -> None:
        """Take one request out of the batch (or mid-prefill) abnormally:
        reclaim its blocks and shared references, null its table row,
        finalize its status; every other slot keeps serving."""
        req = self._active.pop(slot, None) or self._prefilling.pop(slot)
        self._last_prefill_tok.pop(slot, None)
        self.pool.release(slot)
        req._trace("quarantine", status=status, reason=error)
        req._finalize(status, error)
        self.quarantined_requests += 1
        self._m_quarantined.inc()
        self._last_quarantine = {"rid": req.rid, "status": status,
                                 "reason": error, "slot": slot,
                                 "iteration": self.iterations}
        self.scheduler.note_finished()

    def _finish(self, req: Request) -> None:
        self.pool.release(req.slot)
        self._active.pop(req.slot, None)
        self.scheduler.note_finished()
        self._ttft_ms.append(req.ttft_ms)
        self._m_ttft.observe(req.ttft_ms)
        d = req.decode_ms_per_token
        if d is not None:
            self._decode_ms.append(d)
            self._m_tpot.observe(d)

    def stats(self) -> dict:
        """A fresh snapshot: latency means and the registry's percentiles
        (within one bucket of the exact ones), pool and scheduler counters,
        faults, speculation, the flight recorder, and the kernels' launch
        counts (module-wide since last set to 0)."""
        mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
        spec = None
        if self._spec_k:
            spec = {"k": self._spec_k,
                    "drafted_tokens": self.spec_drafted,
                    "accepted_tokens": self.spec_accepted,
                    "rollback_tokens": self.spec_rollback,
                    "accept_rate": (self.spec_accepted / self.spec_drafted
                                    if self.spec_drafted else None),
                    "committed_tokens": self.spec_committed,
                    "draft_steps": self.draft_steps,
                    "verify_steps": self.verify_steps}
        return {
            "iterations": self.iterations,
            "pool": self.pool.stats(),
            "scheduler": self.scheduler.stats(),
            "latency": {"finished": len(self._ttft_ms),
                        "mean_ttft_ms": mean(self._ttft_ms),
                        "mean_decode_ms_per_token": mean(self._decode_ms),
                        **{f"{name}_p{p}_ms": h.percentile(p)
                           for name, h in (("ttft", self._m_ttft),
                                           ("tpot", self._m_tpot))
                           for p in (50, 90, 99)},
                        "step_p50_ms": self._m_step_ms.percentile(50),
                        "step_p99_ms": self._m_step_ms.percentile(99)},
            "faults": {"injected": faults.total_fired(),
                       "contained": self._contained(),
                       "quarantined_requests": self.quarantined_requests,
                       "nan_events": self.nan_events,
                       "callback_errors": self.callback_errors},
            "active": len(self._active),
            "prefilling": len(self._prefilling),
            "peak_running": self.peak_running,
            "preemptions": self.preemptions,
            "decode_stalls": self.decode_stalls,
            "prefill_chunks": self.prefill_chunks,
            "prefill_carry_chunks": self.prefill_carry_chunks,
            "decode_steps": self.decode_steps,
            "speculative": spec,
            "flight_recorder": {"records": len(self.flight_recorder),
                                "ring": self.flight_recorder.maxlen,
                                "dumps": self.flight_recorder.dumps},
            "kernel_launches": {
                "flash_attention": _flash_cuda.launches,
                "paged_attention": _paged_cuda.launches,
                "paged_attention_int8": _paged_cuda.int8_launches,
                "int8_matmul": _wo_cuda.launches,
                "int4_matmul": _wo_cuda.int4_launches},
            "mode": {"preemption": self.config.preemption,
                     "prefix_cache": self.config.prefix_cache,
                     "quantize": self.config.quantize,
                     "kv_cache_dtype": self.spec.storage_dtype,
                     "speculative_k": self._spec_k},
        }

    def health(self) -> dict:
        """Liveness and drain / fault state, without a device sync: this
        engine's entry of the ``serving`` /healthz section."""
        return {"engine": self.metrics_labels["engine"],
                "draining": self._draining,
                "iterations": self.iterations,
                "active": len(self._active),
                "prefilling": len(self._prefilling),
                "queued": self.scheduler.queue_depth,
                "quarantined": self.quarantined_requests,
                "contained": self._contained(),
                "postmortems": len(self.flight_recorder.postmortems),
                "kv_cache_dtype": self.spec.storage_dtype,
                "speculative_k": self._spec_k}


def _health_section() -> dict:
    """The ``serving`` section of ``metrics.health_snapshot()``: every live
    engine's ``health()`` and the fault harness's state."""
    engines = [eng.health() for eng in list(_ENGINES)]
    return {"draining": any(e["draining"] for e in engines),
            "engines": sorted(engines, key=lambda e: int(e["engine"])),
            "faults": faults.stats()}


metrics.register_health_provider("serving", _health_section)
