"""Distributed checkpoints: a sharded save and a resharding load, in the
JAX package's format on disk (``paddle_tpu/parallel/checkpoint.py``), so a
directory written by either package loads in the other:

  metadata.json       {version, tensors: {name: {shape, dtype, chunks:
                      [{index: [[start, stop], ...], file, key}]}}}
  shards_rank<k>.pkl  {key: numpy array}, written by rank k

A value of the state dict is a tensor (the same on every rank: rank 0
writes it whole) or a :class:`LocalShard` (this rank's slice of a global
tensor, as ``ShardedTrainStep.sharded_state_dict`` gives them; only the
slice's owner writes it). Rank 0 writes the metadata of
every rank's chunks. Loading fills each target in place from the chunks
that overlap the region it holds, whatever the mesh that wrote them.

bfloat16: the JAX package pickles ``ml_dtypes.bfloat16`` arrays, which
numpy alone cannot unpickle. The port writes a bf16 tensor's chunks as f32
arrays (exact) under the dtype name "bfloat16", which JAX loads as bf16;
it reads JAX's bf16 chunks where ``ml_dtypes`` is installed and otherwise
refuses them with an error that says so.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtype import as_tensor
from . import collective as C
from . import env

__all__ = ["save_state_dict", "load_state_dict", "flatten_state_dict",
           "unflatten_state_dict", "LocalShard"]

_META = "metadata.json"
_VERSION = 1


class LocalShard:
    """This rank's slice ``tensor`` of a global tensor of ``global_shape``
    at ``offsets`` (one start a dim); ``owner``: this rank writes it (one
    rank among those holding the same slice)."""

    def __init__(self, tensor: torch.Tensor, global_shape: Sequence[int],
                 offsets: Sequence[int], owner: bool = True):
        self.tensor = tensor
        self.global_shape = tuple(int(s) for s in global_shape)
        self.offsets = tuple(int(o) for o in offsets)
        self.owner = owner

    @property
    def index(self) -> List[List[int]]:
        return [[o, o + s] for o, s in zip(self.offsets, self.tensor.shape)]


def flatten_state_dict(sd: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    flat: Dict[str, Any] = {}
    for k, v in sd.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_state_dict(v, prefix=f"{name}."))
        else:
            flat[name] = v
    return flat


def unflatten_state_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in flat.items():
        parts = name.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _as_local(v) -> Optional[LocalShard]:
    """A value as a :class:`LocalShard` (None for anything else)."""
    if isinstance(v, LocalShard):
        return v
    if isinstance(v, torch.Tensor):
        return LocalShard(v, v.shape, (0,) * v.dim(), env.get_rank() == 0)
    return None


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def save_state_dict(state_dict: Dict[str, Any], path: str) -> None:
    """Write a (nested) state dict as a sharded checkpoint directory; every
    rank calls it."""
    flat = flatten_state_dict(state_dict)
    rank = env.get_rank()
    os.makedirs(path, exist_ok=True)
    fname = f"shards_rank{rank}.pkl"
    chunks: Dict[str, np.ndarray] = {}
    entries = {}
    for name, v in flat.items():
        ls = _as_local(v)
        if ls is None:
            continue
        arr, dtype = _to_numpy(ls.tensor)
        key = f"{name}#{rank}"
        entry = {"index": ls.index, "file": fname, "key": key}
        entries[name] = {"shape": list(ls.global_shape), "dtype": dtype,
                         "chunks": [entry] if ls.owner else []}
        if ls.owner:
            chunks[key] = arr
    with open(os.path.join(path, fname), "wb") as f:
        pickle.dump(chunks, f, protocol=4)
    every = C.all_gather_object([], entries)
    if rank == 0:
        meta = {}
        for part in every:
            for name, m in part.items():
                meta.setdefault(name, dict(m, chunks=[]))["chunks"] \
                    .extend(m["chunks"])
        with open(os.path.join(path, _META), "w") as f:
            json.dump({"version": _VERSION, "tensors": meta}, f)
    C.barrier()


def _unpickle(path: str):
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except ModuleNotFoundError as e:
        if "ml_dtypes" in str(e):
            raise RuntimeError(
                f"checkpoint {path} holds bfloat16 chunks pickled as "
                f"ml_dtypes arrays (as the JAX package writes them) and "
                f"ml_dtypes is not installed; load it where ml_dtypes is, "
                f"or save it from f32 tensors") from e
        raise


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    strict: bool = True) -> Dict[str, Any]:
    """Fill ``state_dict``'s tensors in place from a checkpoint directory,
    each with the region it holds (a tensor: all of it; a
    :class:`LocalShard`: its slice). Returns
    ``state_dict``."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)["tensors"]
    flat = flatten_state_dict(state_dict)
    missing = [n for n in flat if n not in meta]
    if missing and strict:
        raise KeyError(f"checkpoint {path} is missing tensors: "
                       f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    files: Dict[str, Dict[str, np.ndarray]] = {}

    def chunk(entry) -> np.ndarray:
        fn = entry["file"]
        if fn not in files:
            files[fn] = _unpickle(os.path.join(path, fn))
        return files[fn][entry["key"]]

    for name, v in flat.items():
        if name not in meta:
            continue
        m = meta[name]
        ls = _as_local(v)
        if ls is None:
            continue
        if tuple(m["shape"]) != ls.global_shape:
            if strict:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{ls.global_shape} vs saved "
                                 f"{tuple(m['shape'])}")
            continue
        lo = ls.offsets
        hi = tuple(o + s for o, s in zip(lo, ls.tensor.shape))
        buf = torch.zeros(ls.tensor.shape, dtype=torch.float64
                          if ls.tensor.is_floating_point() else torch.int64)
        for e in m["chunks"]:
            inter = [(max(a, l), min(b, h)) for (a, b), l, h
                     in zip(e["index"], lo, hi)]
            if any(a >= b for a, b in inter):
                continue
            src = tuple(slice(a - c[0], b - c[0])
                        for (a, b), c in zip(inter, e["index"]))
            dst = tuple(slice(a - l, b - l) for (a, b), l in zip(inter, lo))
            buf[dst] = as_tensor(np.asarray(chunk(e))[src]).to(buf.dtype)
        with torch.no_grad():
            ls.tensor.copy_(buf.to(ls.tensor.dtype))
    return state_dict
