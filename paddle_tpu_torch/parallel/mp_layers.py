"""Megatron-style tensor-parallel layers (the counterpart of
``paddle_tpu/parallel/mp_layers.py``) with explicit collectives over the
``tp`` axis.

Where the JAX layers hold the full weight and leave the collectives to
GSPMD, each of these holds its rank's shard of the JAX layout (``[in,
out]``) and places the collectives itself (``mp_ops``):
``ColumnParallelLinear`` (``W[:, shard]``; the input through
``c_identity``, the output all-gathered with ``gather_output``),
``RowParallelLinear`` (``W[shard, :]``; the input split unless
``input_is_parallel``, the partial products all-reduced, the bias added
once), ``VocabParallelEmbedding`` (rows of the vocab: a masked lookup and
an all-reduce) and ``ParallelCrossEntropy`` (softmax cross entropy over
vocab-sharded logits: the max, the sum of exponentials and the target logit
reduced over tp). Weights are drawn whole from a generator seeded with
``seed`` (the same on every rank) and sliced, so a layer equals its dense
counterpart at any tp degree; ``load_full`` takes a full ``[in, out]``
weight. On one rank (or without a mesh) they are the dense layers.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from . import collective as C
from .mp_ops import c_concat, c_identity, c_split, mp_allreduce

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy",
           "get_rng_state_tracker", "RNGStatesTracker",
           "vocab_parallel_cross_entropy", "vocab_parallel_embedding",
           "column_parallel_linear", "row_parallel_linear"]


def _tp(group):
    """``(axis or group, degree, this rank's index)`` of the tp group."""
    import torch.distributed as dist

    axis = "tp" if group is None else group
    from . import env

    if env.get_mesh() is None and group is None:
        return None, 1, 0
    pg, n = C.resolve_group(axis)
    return axis, n, (dist.get_rank(pg) if n > 1 else 0)


def _xavier(shape, gen, device, dtype):
    fan_in, fan_out = shape[0], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.uniform_(-bound, bound, generator=gen)
    return w.to(dtype)


class _Sharded(nn.Module):
    """A weight sharded along ``dim`` over the tp group."""

    shard_dim = 0

    def _setup(self, shape, mp_group, device, dtype, seed):
        self.axis, self.nranks, self.rank = _tp(mp_group)
        if shape[self.shard_dim] % self.nranks:
            raise ValueError(f"{type(self).__name__}: dim {self.shard_dim} "
                             f"of {shape} does not divide over "
                             f"{self.nranks} tp ranks")
        dev = resolve_device(device)
        full = _xavier(shape, make_generator(seed, dev), dev,
                       to_torch_dtype(dtype))
        self.weight = nn.Parameter(self._local(full))

    def _local(self, full):
        return full.chunk(self.nranks, dim=self.shard_dim)[self.rank] \
            .contiguous()

    @torch.no_grad()
    def load_full(self, weight, bias=None):
        """Take this rank's shard of a full (JAX-layout) weight."""
        self.weight.copy_(self._local(torch.as_tensor(weight)))
        if bias is not None and getattr(self, "bias", None) is not None:
            b = torch.as_tensor(bias)
            self.bias.copy_(b.chunk(self.nranks)[self.rank]
                            if self.shard_dim == 1 else b)


class VocabParallelEmbedding(_Sharded):
    """Embedding with the vocab rows sharded over tp."""

    shard_dim = 0

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self._setup((num_embeddings, embedding_dim), mp_group, device, dtype,
                    seed)

    def forward(self, ids):
        return vocab_parallel_embedding(ids, self.weight, self.axis,
                                        self.nranks, self.rank)


def vocab_parallel_embedding(ids, weight, axis, nranks, rank):
    """The lookup of ``ids`` in a vocab shard ``weight`` (rows ``rank *
    V_local ..``): ids of other shards give zeros, then the sum over tp."""
    if nranks == 1:
        return F.embedding(ids, weight)
    rows = weight.shape[0]
    start = rank * rows
    inside = (ids >= start) & (ids < start + rows)
    local = torch.where(inside, ids - start, torch.zeros_like(ids))
    out = F.embedding(local, weight) * inside[..., None].to(weight.dtype)
    return mp_allreduce(out, axis)


class ColumnParallelLinear(_Sharded):
    """``y = x W + b``, ``W [in, out]`` sharded on ``out``;
    ``gather_output`` all-gathers y's last dim, else y stays sharded for a
    following :class:`RowParallelLinear`."""

    shard_dim = 1

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: Optional[bool] = None, gather_output: bool = True,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self._setup((in_features, out_features), mp_group, device, dtype,
                    seed)
        # Paddle: has_bias=None means no bias
        self.bias = nn.Parameter(torch.zeros(
            out_features // self.nranks, device=self.weight.device,
            dtype=self.weight.dtype)) if has_bias else None

    def forward(self, x):
        return column_parallel_linear(x, self.weight, self.bias, self.axis,
                                      self.nranks, self.gather_output)


def column_parallel_linear(x, weight, bias=None, axis="tp", nranks=1,
                           gather_output=False):
    """``x W + b`` with ``W [in, out_local]`` and ``b`` this rank's output
    columns: the input through ``c_identity`` (its gradient summed over
    tp), the output all-gathered with ``gather_output``."""
    y = (c_identity(x, axis) if nranks > 1 else x) @ weight
    if bias is not None:
        y = y + bias
    return c_concat(y, axis, -1) if gather_output and nranks > 1 else y


class RowParallelLinear(_Sharded):
    """``y = x W + b``, ``W [in, out]`` sharded on ``in``; the partial
    products summed over tp, the (replicated) bias added once."""

    shard_dim = 0

    def __init__(self, in_features: int, out_features: int, weight_attr=None,
                 has_bias: bool = True, input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self._setup((in_features, out_features), mp_group, device, dtype,
                    seed)
        self.bias = nn.Parameter(torch.zeros(
            out_features, device=self.weight.device,
            dtype=self.weight.dtype)) if has_bias else None

    def forward(self, x):
        return row_parallel_linear(x, self.weight, self.bias, self.axis,
                                   self.nranks, self.input_is_parallel)


def row_parallel_linear(x, weight, bias=None, axis="tp", nranks=1,
                        input_is_parallel=True):
    """``x W + b`` with ``W [in_local, out]``: the input split unless
    ``input_is_parallel``, the partial products all-reduced over tp, the
    (replicated) bias added once."""
    if nranks > 1:
        if not input_is_parallel:
            x = c_split(x, axis, -1)
        y = mp_allreduce(x @ weight, axis)
    else:
        y = x @ weight
    return y if bias is None else y + bias


def vocab_parallel_cross_entropy(logits, label, axis="tp",
                                 ignore_index: int = -100):
    """Per-token softmax cross entropy ``[...]`` (f32) of vocab-sharded
    ``logits [..., V_local]`` (rank r holds classes ``r * V_local ..``)
    against ``label [...]``; 0 where the label is ``ignore_index``."""
    pg, n = C.resolve_group(axis)
    z = logits.float()
    valid = label != ignore_index
    if n == 1:
        per = F.cross_entropy(z.reshape(-1, z.shape[-1]),
                              label.reshape(-1), ignore_index=ignore_index,
                              reduction="none")
        return per.reshape(label.shape)
    import torch.distributed as dist

    v = z.shape[-1]
    start = dist.get_rank(pg) * v
    with torch.no_grad():
        m = C.all_reduce(z.amax(dim=-1), op=C.ReduceOp.MAX, group=axis)
    e = torch.exp(z - m[..., None])
    sumexp = mp_allreduce(e.sum(dim=-1), axis)
    inside = (label >= start) & (label < start + v) & valid
    local = torch.where(inside, label - start, torch.zeros_like(label))
    picked = z.gather(-1, local[..., None])[..., 0] * inside.to(z.dtype)
    target = mp_allreduce(picked, axis)
    per = torch.log(sumexp) + m - target
    return torch.where(valid, per, torch.zeros_like(per))


class ParallelCrossEntropy(nn.Module):
    """Softmax cross entropy over tp-sharded logits; returns the per-token
    loss ``[..., 1]`` as JAX does."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.axis = _tp(mp_group)[0]
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        loss = vocab_parallel_cross_entropy(input, label, self.axis,
                                            self.ignore_index)
        return loss[..., None]


class RNGStatesTracker:
    """Named random streams (Paddle's ``mpu/random.py``): each a
    ``torch.Generator``. ``rng_state(name)`` yields the stream's generator
    and, inside, makes it the default generator of its device (its state
    is kept on exit), so dropout that draws from the default one draws
    from the stream."""

    def __init__(self):
        self.states_: Dict[str, torch.Generator] = {}

    def reset(self, base_seed: int = 0) -> None:
        self.states_ = {}

    def add(self, name: str, seed: int, device="cpu") -> None:
        if name in self.states_:
            raise ValueError(f"rng state {name!r} already exists")
        self.states_[name] = make_generator(seed, device)

    def get_states_tracker(self):
        return {k: g.get_state() for k, g in self.states_.items()}

    def set_states_tracker(self, states) -> None:
        for k, s in states.items():
            self.states_[k].set_state(s)

    @contextlib.contextmanager
    def rng_state(self, name: str = "global_seed"):
        if name not in self.states_:
            self.add(name, hash(name) & 0x7FFFFFFF)
        gen = self.states_[name]
        cuda = gen.device.type == "cuda"
        saved = torch.cuda.get_rng_state(gen.device) if cuda \
            else torch.get_rng_state()
        (torch.cuda.set_rng_state(gen.get_state(), gen.device) if cuda
         else torch.set_rng_state(gen.get_state()))
        try:
            yield gen
        finally:
            now = torch.cuda.get_rng_state(gen.device) if cuda \
                else torch.get_rng_state()
            gen.set_state(now)
            (torch.cuda.set_rng_state(saved, gen.device) if cuda
             else torch.set_rng_state(saved))


_tracker = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _tracker
