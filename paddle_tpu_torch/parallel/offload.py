"""Host offload for sharded training (the counterpart of
``paddle_tpu/parallel/offload.py``; Paddle's ``async_load.cc`` and
``GroupShardedStage3(..., offload=True)``): an asynchronous loader between
host and card, and a stage-3 step whose optimizer state lives on the host
between steps.

``AsyncLoader`` copies on a side CUDA stream of its own: host buffers are
pinned, each copy waits for the work the current stream had enqueued when
it was asked for (an event), and ``wait`` makes the current stream wait for
a prefetch (or the host for an offload). The allocator is told that the
side stream uses the tensors it copies (``record_stream``), so none is
reused before its copy is done. On CPU tensors the same calls copy (or
hand over) host tensors and wait for nothing.

``OffloadedTrainStep`` is ``ShardedTrainStep`` at stage 3 with the
optimizer state on the host: created one parameter at a time and moved out
at once; each step starts the first parameter's state toward the card as
soon as the backward is enqueued, then updates the parameters one by one,
prefetching the next parameter's state while one updates and writing each
updated state back into its pinned host buffers, so that the card holds
at most two parameters' state and the last write-backs overlap the next
step's forward.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from .sharding import ShardedTrainStep, ShardingStage

__all__ = ["AsyncLoader", "OffloadedTrainStep"]


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor (dicts in key order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree) if torch.is_tensor(tree) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


class AsyncLoader:
    """Host <-> card copies of tensors and nested dicts / lists of them:
    ``offload(tree, out=None)`` starts the copies to the host (into ``out``'s
    tensors when given, else new pinned buffers), ``prefetch(tree, device)``
    starts them to the card, and ``wait(tree)`` joins. With ``timing`` each
    call's copies are timed on the side stream (CUDA events):
    :meth:`transfer_ms` sums them."""

    def __init__(self, device=None, timing: bool = False):
        self._device = torch.device(device) if device is not None else (
            torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))
        self._cuda = self._device.type == "cuda"
        self._stream = torch.cuda.Stream(self._device) if self._cuda \
            else None
        self._done: Dict[int, Any] = {}
        self._timing = timing and self._cuda
        self._spans: Dict[str, List[tuple]] = {"h2d": [], "d2h": []}

    def _copy(self, tree, make, what):
        """``make(src)``'s destination filled from src for every leaf, on the
        side stream after the current stream's work so far."""
        if not self._cuda:
            return _map(make, tree)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self._device))
        out_leaves = []

        def copy(src):
            dst = make(src)
            dst.copy_(src, non_blocking=True)
            for t in (src, dst):
                if t.is_cuda:
                    t.record_stream(self._stream)
            out_leaves.append(dst)
            return dst

        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            if self._timing:
                t0 = torch.cuda.Event(enable_timing=True)
                t0.record(self._stream)
            out = _map(copy, tree)
            done = torch.cuda.Event(enable_timing=self._timing)
            done.record(self._stream)
        if self._timing:
            self._spans[what].append((t0, done))
        for t in out_leaves:
            self._done[id(t)] = done
        return out

    def offload(self, tree, out=None):
        """Start copying ``tree`` to the host; returns the host tree (``out``,
        of the same structure, filled in place when given)."""
        if out is not None:
            dst = iter(_leaves(out))
            if not self._cuda:
                for src in _leaves(tree):
                    next(dst).copy_(src)
            else:
                self._copy(tree, lambda src: next(dst), "d2h")
            return out
        if not self._cuda:
            return _map(lambda t: t.detach().clone(), tree)
        return self._copy(tree, lambda src: torch.empty(
            src.shape, dtype=src.dtype, pin_memory=True), "d2h")

    def prefetch(self, tree, device=None):
        """Start copying ``tree`` to ``device`` (default the loader's);
        returns the device tree. On the CPU the tensors themselves."""
        dev = torch.device(device) if device is not None else self._device
        if dev.type != "cuda":
            return tree
        return self._copy(tree, lambda src: torch.empty(
            src.shape, dtype=src.dtype, device=dev), "h2d")

    def wait(self, tree):
        """Join the copies that made ``tree``: the current stream waits for
        a prefetch, the host for an offload. Returns ``tree``."""
        for leaf in _leaves(tree):
            ev = self._done.pop(id(leaf), None)
            if ev is None:
                continue
            if leaf.is_cuda:
                torch.cuda.current_stream(leaf.device).wait_event(ev)
            else:
                ev.synchronize()
        return tree

    def transfer_ms(self) -> Dict[str, float]:
        """The side stream's time in host-to-card and card-to-host copies
        since the last call (synchronises with them), in ms."""
        out = {}
        for what, spans in self._spans.items():
            total = 0.0
            for t0, t1 in spans:
                t1.synchronize()
                total += t0.elapsed_time(t1)
            out[what] = total
            spans.clear()
        return out


class OffloadedTrainStep(ShardedTrainStep):
    """``step = OffloadedTrainStep(model, loss_fn, optimizer, mesh, rules,
    batch_spec, clip_norm)``: :class:`~.sharding.ShardedTrainStep` at stage
    3 whose optimizer state lives on the host between steps (``_host_state``,
    pinned on a card), streamed through the card one parameter at a time by
    an :class:`AsyncLoader` (``loader``). ``offload_master`` is accepted for
    JAX's signature: the port's update keeps no f32 master here."""

    def __init__(self, model, loss_fn, optimizer, mesh,
                 rules: Optional[list] = None, batch_spec=None,
                 clip_norm: Optional[float] = None,
                 offload_master: bool = True, timing: bool = False):
        dev = next(model.parameters()).device
        self.loader = AsyncLoader(dev, timing=timing)
        self._pending: Dict[int, Any] = {}
        super().__init__(model, loss_fn, optimizer, mesh,
                         stage=ShardingStage.P_G_OS, rules=rules,
                         batch_spec=batch_spec, clip_norm=clip_norm)

    def _init_opt_state(self, views):
        # one parameter's state at a time on the card, moved out at once
        host = []
        for v in views:
            st = self._opt.init_state([v])[0]
            host.append(self.loader.wait(self.loader.offload(st)))
            del st
        return host

    @property
    def _host_state(self) -> List[Dict[str, torch.Tensor]]:
        return self._state

    def _grads_enqueued(self) -> None:
        if self._state and 0 not in self._pending:
            self._pending[0] = self.loader.prefetch(self._state[0])

    def _apply_update(self, views, grads) -> None:
        lr = self._opt.get_lr()
        n = len(views)
        for i in range(n):
            if i not in self._pending:
                self._pending[i] = self.loader.prefetch(self._state[i])
            if i + 1 < n:
                self._pending[i + 1] = self.loader.prefetch(
                    self._state[i + 1])
            one = [self.loader.wait(self._pending.pop(i))]
            self._opt.apply_gradients_([views[i]], [grads[i]], one, lr,
                                       self._step)
            grads[i] = None
            self.loader.offload(one[0], out=self._state[i])
            del one
