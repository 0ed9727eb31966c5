"""The global runtime flags (the counterpart of ``paddle_tpu/core/flags.py``):
one process-wide registry of typed flags, each read from a ``FLAGS_<name>``
environment variable when it is defined and settable from Python
(``paddle.set_flags`` / ``paddle.get_flags``).

The registry holds every flag the JAX package defines, with its default
and type, so that ``get_flags()`` reads the same in both. The port acts on
the flags of :data:`ACTED_ON`: ``mamba_logdepth_scan`` (the selective
scan's log-depth kernels, ``ops/cuda/selective_scan.py``) and
``selective_scan_blocks`` (that scan's span). The other flags configure
layers of the JAX package (XLA, Pallas, its serving runtime) and are kept
so that code setting them runs unchanged; setting one of them to a value
other than its default (by ``set_flags`` or ``FLAGS_<name>``) warns once
that the port ignores it. Each goes when its layer is ported or dropped.
``core/metrics.py``, ``core/faults.py`` and ``core/observatory.py`` keep
their own switches.
"""

from __future__ import annotations

import os
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

__all__ = ["define_flag", "get_flags", "set_flags", "flag", "ACTED_ON"]

#: the flags the port reads
ACTED_ON = frozenset({"mamba_logdepth_scan", "selective_scan_blocks"})

_TRUE_STRINGS = {"1", "true", "yes", "on"}
_FALSE_STRINGS = {"0", "false", "no", "off"}


def _parse(value: str, ty: type) -> Any:
    if ty is bool:
        v = value.strip().lower()
        if v in _TRUE_STRINGS:
            return True
        if v in _FALSE_STRINGS:
            return False
        raise ValueError(f"cannot parse boolean flag value {value!r}")
    return ty(value)


@dataclass
class _FlagDef:
    name: str
    default: Any
    ty: type
    help: str
    validator: Optional[Callable[[Any], bool]] = None


class _FlagRegistry:
    def __init__(self) -> None:
        self._defs: Dict[str, _FlagDef] = {}
        self._values: Dict[str, Any] = {}
        self._warned: set = set()
        self._lock = threading.Lock()

    def _note(self, name: str, value: Any) -> None:
        """Warn once a flag the port does not read leaves its default."""
        if (name in ACTED_ON or name in self._warned
                or value == self._defs[name].default):
            return
        self._warned.add(name)
        warnings.warn(f"flag {name!r} = {value!r}: the port keeps this "
                      f"flag of the JAX package but does not act on it",
                      stacklevel=4)

    def define(self, name: str, default: Any, help: str = "",
               ty: Optional[type] = None,
               validator: Optional[Callable[[Any], bool]] = None) -> None:
        ty = ty or type(default)
        with self._lock:
            if name in self._defs:
                raise ValueError(f"flag {name!r} already defined")
            self._defs[name] = _FlagDef(name, default, ty, help, validator)
            env = os.environ.get(f"FLAGS_{name}")
            self._values[name] = default if env is None else _parse(env, ty)
            self._note(name, self._values[name])

    def get(self, name: str) -> Any:
        try:
            return self._values[name]
        except KeyError:
            raise KeyError(f"unknown flag {name!r}") from None

    def set(self, name: str, value: Any) -> None:
        with self._lock:
            d = self._defs.get(name)
            if d is None:
                raise KeyError(f"unknown flag {name!r}")
            if isinstance(value, str) and d.ty is not str:
                value = _parse(value, d.ty)
            if not isinstance(value, d.ty):
                if d.ty is float and isinstance(value, int):
                    value = float(value)
                else:
                    raise TypeError(f"flag {name!r} expects "
                                    f"{d.ty.__name__}, got "
                                    f"{type(value).__name__}")
            if d.validator is not None and not d.validator(value):
                raise ValueError(f"invalid value {value!r} for flag {name!r}")
            self._values[name] = value
            self._note(name, value)

    def names(self) -> List[str]:
        return sorted(self._defs)


_registry = _FlagRegistry()


def define_flag(name, default, help="", ty=None, validator=None):
    """Define a new global flag, read from ``FLAGS_<name>`` if it is set."""
    _registry.define(name, default, help=help, ty=ty, validator=validator)


def flag(name: str) -> Any:
    """One flag's value."""
    return _registry.get(name)


def get_flags(names=None) -> Dict[str, Any]:
    """Read flags: ``names`` a str, a list of str, or None for all."""
    if names is None:
        names = _registry.names()
    if isinstance(names, str):
        names = [names]
    return {n: _registry.get(n) for n in names}


def set_flags(flags: Dict[str, Any]) -> None:
    """Set several flags from a dict (``paddle.set_flags``); a string is
    parsed as the environment's values are."""
    for k, v in flags.items():
        _registry.set(k, v)


# ---------------------------------------------------------------------------
# The JAX package's definitions, in its order, with its defaults. The help
# says what each selects there; the port's readers are named where it has
# them.
# ---------------------------------------------------------------------------

define_flag("check_nan_inf", False,
            "Check every op output for NaN/Inf (debugging).")
define_flag("check_nan_inf_level", 0,
            "0: error on nan/inf; 1: warn; 2: collect stats only.")
define_flag("use_pallas_kernels", True,
            "Use the hand-written kernels for fused ops.")
define_flag("wkv_pallas_chunk", 0,
            "Chunk length of the fused whole-layer WKV kernel (0 = auto by "
            "batch).")
define_flag("wkv_pallas_subchunk", 16,
            "Sub-chunk block of the fused WKV kernel's decay cube.")
define_flag("ssd_pallas_chunk", 128,
            "Chunk length of the fused whole-layer SSD kernel.")
define_flag("ssd_use_pallas", False,
            "Route ssd_chunked onto the whole-layer SSD kernel.")
define_flag("moe_fused_swiglu", True,
            "Fuse gate + up + swiglu into one grouped-GEMM pass in MoE "
            "experts.")
define_flag("moe_recompute_activation", False,
            "Drop the fused swiglu's pre-activation residuals and re-run it "
            "in the backward.")
define_flag("static_verify_between_passes", True,
            "Verify a Program's structure after every pass.")
define_flag("static_verify_sharding", False,
            "Re-audit SPMD placements after every pass.")
define_flag("static_compile_cache_dir", "",
            "Directory of the persistent compilation cache ('' = off).")
define_flag("static_engine_verify", True,
            "Verify a Program once per binding-plan build.")
define_flag("prim_enabled", False,
            "Decompose composite ops into prim bodies at dispatch.")
define_flag("flash_attention_autotune", True,
            "Consult the per-shape flash block-size autotune cache.")
define_flag("flash_attention_block_q", 0,
            "Override the flash-attention q block size (0 = auto).")
define_flag("flash_attention_block_kv", 0,
            "Override the flash-attention kv block size (0 = auto).")
define_flag("eager_record_op_names", True,
            "Record op names on autograd nodes (debugging / profiler).")
define_flag("matmul_precision", "default",
            "Matmul precision: default|high|highest.")
define_flag("amp_dtype", "bfloat16", "Default autocast low-precision dtype.")
define_flag("embedding_deterministic", False,
            "Force a deterministic embedding gradient scatter.")
define_flag("distributed_timeout_s", 1800.0,
            "Collective watchdog timeout in seconds.")
define_flag("log_level", 0, "Verbose log level (VLOG).")
define_flag("allocator_strategy", "xla", "Memory allocator strategy.")
define_flag("benchmark_iters", 20, "Iterations for bench.py timing loops.")
define_flag("ring_pallas_force", False,
            "Route ring attention onto the kernelised hop body off the "
            "accelerator.")
define_flag("pallas_vmem_budget_bytes", 16 * 1024 * 1024,
            "Per-core fast-memory budget (bytes) the static kernel auditor "
            "checks block working sets against.")
define_flag("pallas_audit", False,
            "Audit every kernel's grid and working set at trace time.")
define_flag("pallas_autotune", True,
            "Consult the per-shape block-size autotune cache.")
define_flag("ring_attention_blocks", "",
            "Override ring-attention hop blocks as 'bq,bk' (empty = auto).")
define_flag("paged_attention_blocks", "",
            "Override the paged-attention kernel selector as 'seq_grid' "
            "(empty = auto).")
define_flag("selective_scan_blocks", "",
            "Override the selective scan's time chunk as 'chunk' (0 / empty "
            "= the caller's chunk). The port reads it for the log-depth "
            "scan's span (ops/cuda/selective_scan.py:scan_span).")
define_flag("ssd_blocks", "",
            "Override the SSD time chunk as 'chunk' (empty = auto).")
define_flag("wkv_blocks", "",
            "Override the WKV chunking as 'chunk,sub' (empty = auto).")
define_flag("grouped_gemm_blocks", "",
            "Override grouped-GEMM tiles as 'tm,tk,tn' (empty = auto).")
define_flag("int8_matmul_blocks", "",
            "Override the int8 / int4 weight-matmul tiles as 'tk,tn' "
            "(empty = auto).")
define_flag("fused_adamw_blocks", "",
            "Override the fused AdamW rows a block as 'rows' (empty = "
            "auto).")
define_flag("flash_attention_blocks", "",
            "Override flash-attention blocks as 'bq,bk' (empty = auto).")
define_flag("serving_block_size", 16,
            "KV block (page) size in tokens of the serving runtime.")
define_flag("serving_max_batch", 8,
            "Decode slots of the continuous-batching runtime.")
define_flag("serving_prefill_token_budget", 512,
            "Max prompt tokens prefilled per engine iteration.")
define_flag("serving_num_blocks", 0,
            "KV block-pool size of the serving runtime (0 = auto).")
define_flag("serving_preemption", True,
            "Optimistic admission and LRU preemption in the serving "
            "runtime.")
define_flag("serving_kv_cache_dtype", "",
            "Storage dtype of the serving runtime's paged KV pool ('' = "
            "the model dtype, 'int8' = quantized blocks).",
            validator=lambda v: v in ("", "int8"))
define_flag("serving_prefix_cache", True,
            "Shared-prefix KV block caching with copy-on-write semantics.")
define_flag("fault_inject", "",
            "Deterministic fault-injection schedule ('' = disarmed).")
define_flag("pallas_fallback", "auto",
            "Per-kernel degradation: 'auto', 'raise' or 'reference'.",
            validator=lambda v: v in ("auto", "raise", "reference"))
define_flag("serving_nan_sentinel", True,
            "Per-iteration NaN/Inf sentinel of the serving runtime.")
define_flag("perf_sample_every", 0,
            "Time every Nth dispatch of each executable (0 = off).")
define_flag("serving_flight_recorder_len", 256,
            "Ring size (engine iterations) of the serving flight recorder.")
define_flag("serving_postmortem_dir", "",
            "Directory of the flight recorder's postmortem files ('' = in "
            "memory).")
define_flag("fleet_slo_step_ms", 1000.0,
            "Fleet router load scoring: the step-time SLO a replica's p99 "
            "is normalised against.")
define_flag("fleet_affinity_spill", 4,
            "Prefix-affinity spill threshold of the fleet router.")
define_flag("fleet_scale_up_queue", 4.0,
            "Autoscaler scale-up trigger: mean queue depth per replica.")
define_flag("fleet_scale_down_util", 0.25,
            "Autoscaler scale-down trigger: decode-slot utilisation.")
define_flag("fleet_min_replicas", 1, "Autoscaler floor.")
define_flag("fleet_max_replicas", 8, "Autoscaler ceiling.")
define_flag("fleet_autoscale_cooldown", 8,
            "Fleet steps between autoscaler actions.")
define_flag("static_compile_retries", 1,
            "Retries for a failed ahead-of-time compile.")
define_flag("mamba_logdepth_scan", False,
            "Selective scan: replace the sequential in-chunk recurrences "
            "with log-depth Hillis-Steele scans over each span of "
            "scan_span(l, chunk) steps, forward and backward. In the port: "
            "the log-depth kernels of csrc/selective_scan.cu on CUDA "
            "tensors, their plain versions on CPU tensors.")
