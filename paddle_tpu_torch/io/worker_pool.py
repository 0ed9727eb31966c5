"""Process workers of the DataLoader over a shared-memory slab ring (the
counterpart of ``paddle_tpu/io/worker_pool.py``).

  * Workers are ``fork``ed, possibly after the parent has initialised CUDA,
    so they must never touch torch (a forked child cannot use the parent's
    CUDA context): the worker loop imports only numpy, collates to numpy,
    and exits with ``os._exit`` so no inherited atexit teardown runs in the
    child.
  * Array payloads travel through a fixed pool of shared-memory slots
    (size = prefetch depth); only shapes, dtypes and offsets go through the
    metadata queue. Oversized batches degrade to queue pickling.
  * Batch order is preserved: tasks carry indices, the parent reorders
    results.
  * Each worker seeds numpy and ``random`` from the epoch's base seed, and
    again for each task from its batch index, so augmentation does not
    depend on which worker serves a batch.

Torch tensors are made in the parent only (``wrap_fn``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as _queue
import traceback
from multiprocessing import shared_memory
from typing import Callable, Optional

import numpy as np

__all__ = ["ProcessPoolIterator", "WorkerInfo", "get_worker_info"]


class _WorkerError:
    """A batch's worker traceback, held until that batch's turn."""

    def __init__(self, text: str):
        self.text = text


class WorkerInfo:
    """``paddle.io.get_worker_info`` parity object (reader.py worker_info):
    available inside dataset/transform code running in a worker process."""

    def __init__(self, id: int, num_workers: int, seed: int, dataset=None):  # noqa: A002
        self.id = id
        self.num_workers = num_workers
        self.seed = seed
        self.dataset = dataset


_worker_info: Optional[WorkerInfo] = None


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker process: that worker's WorkerInfo; None in the main
    process."""
    return _worker_info


# ---------------------------------------------------------------------------
# numpy-only collation (worker side: torch is never called here)
# ---------------------------------------------------------------------------

def np_collate(batch):
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number, np.bool_)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, dict):
        return {k: np_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return type(sample)(np_collate(list(col)) for col in zip(*batch))
    # anything else is passed through for the parent to deal with
    return list(batch)


def _flatten_arrays(obj, out):
    """Replace ndarray leaves with placeholders, collecting them in order."""
    if isinstance(obj, np.ndarray):
        out.append(obj)
        return _ArrayRef(len(out) - 1, obj.shape, str(obj.dtype))
    if isinstance(obj, dict):
        return {k: _flatten_arrays(v, out) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_flatten_arrays(v, out) for v in obj)
    return obj


class _ArrayRef:
    __slots__ = ("idx", "shape", "dtype")

    def __init__(self, idx, shape, dtype):
        self.idx = idx
        self.shape = shape
        self.dtype = dtype


def _unflatten_arrays(obj, arrays):
    if isinstance(obj, _ArrayRef):
        return arrays[obj.idx]
    if isinstance(obj, dict):
        return {k: _unflatten_arrays(v, arrays) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_unflatten_arrays(v, arrays) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# worker process
# ---------------------------------------------------------------------------

def _worker_loop(dataset, collate_fn, index_q, data_q, free_q, shm_name,
                 slot_bytes, worker_id, num_workers, seed, init_fn):
    """Runs in the forked child. numpy-only; exits via os._exit so the
    inherited atexit hooks never run here."""
    global _worker_info
    _worker_info = WorkerInfo(worker_id, num_workers, seed, dataset)
    shm = shared_memory.SharedMemory(name=shm_name)
    try:
        # per-worker RNG seeding (base_seed + worker_id)
        # — forked children otherwise inherit the parent's identical global
        # RNG state and replay the same augmentation stream
        import random as _random

        np.random.seed(seed & 0xFFFFFFFF)
        _random.seed(seed)
        try:
            if init_fn is not None:
                init_fn(worker_id)
        except Exception:
            data_q.put(("error", -1, None,
                        pickle.dumps(traceback.format_exc())))
            return
        base_seed = seed - worker_id
        while True:
            task = index_q.get()
            if task is None:
                break
            bidx, indices = task
            try:
                # per-TASK reseed: the pool is work-stealing (a shared index
                # queue), so which worker serves a batch is scheduling-
                # dependent; seeding by batch index makes augmentation
                # deterministic under a fixed base seed regardless of
                # worker assignment (stronger than per-worker seeding
                # alone). A user worker_init_fn takes
                # manual control of RNG — don't overwrite its seeding.
                if init_fn is None:
                    task_seed = base_seed + num_workers + bidx
                    np.random.seed(task_seed & 0xFFFFFFFF)
                    _random.seed(task_seed)
                    # keep get_worker_info().seed describing the LIVE
                    # stream (datasets seeding their own Generator from it
                    # stay deterministic under work-stealing)
                    _worker_info.seed = task_seed
                samples = [dataset[i] for i in indices]
                data = (collate_fn or np_collate)(samples)
                arrays: list = []
                skeleton = _flatten_arrays(data, arrays)
                total = sum(a.nbytes for a in arrays)
                if total <= slot_bytes:
                    slot = free_q.get()
                    off = slot * slot_bytes
                    offsets = []
                    for a in arrays:
                        a = np.ascontiguousarray(a)
                        # write straight into the slab (no tobytes() copy)
                        dst = np.frombuffer(shm.buf, dtype=np.uint8,
                                            count=a.nbytes, offset=off)
                        dst[:] = a.reshape(-1).view(np.uint8)
                        del dst
                        offsets.append(off - slot * slot_bytes)
                        off += a.nbytes
                    data_q.put(("shm", bidx, slot,
                                pickle.dumps((skeleton, offsets))))
                else:  # oversized batch: degrade to queue pickling
                    data_q.put(("pickle", bidx, None,
                                pickle.dumps((skeleton, arrays))))
            except Exception:
                data_q.put(("error", bidx, None,
                            pickle.dumps(traceback.format_exc())))
    except (KeyboardInterrupt, EOFError, BrokenPipeError):
        pass
    finally:
        try:
            shm.close()
            # flush the queue's feeder thread BEFORE os._exit, or a crash
            # report posted just before exit is silently dropped
            data_q.close()
            data_q.join_thread()
        except Exception:
            pass
        finally:
            os._exit(0)


# ---------------------------------------------------------------------------
# parent-side iterator
# ---------------------------------------------------------------------------

class ProcessPoolIterator:
    """Order-preserving iterator over batches produced by forked workers.

    ``wrap_fn`` maps the reassembled numpy pytree to the user-facing batch
    (torch tensors) in the parent. One pool instance = one epoch unless
    ``persistent`` (the DataLoader re-feeds tasks each epoch)."""

    def __init__(self, dataset, batches, num_workers: int,
                 collate_fn: Optional[Callable], wrap_fn: Callable,
                 slot_bytes: int = 64 << 20, prefetch_factor: int = 2,
                 timeout: float = 0, worker_init_fn: Optional[Callable] = None,
                 seed: int = 0):
        ctx = mp.get_context("fork")
        self._batches = list(batches)
        self._wrap = wrap_fn
        self._timeout = timeout
        self._n_slots = max(2, prefetch_factor * num_workers)
        self._slot_bytes = int(slot_bytes)
        self._shm = shared_memory.SharedMemory(
            create=True, size=self._n_slots * self._slot_bytes)
        self._index_q = ctx.Queue()
        self._data_q = ctx.Queue()
        self._free_q = ctx.Queue()
        for s in range(self._n_slots):
            self._free_q.put(s)
        self._workers = [
            ctx.Process(
                target=_worker_loop,
                args=(dataset, collate_fn, self._index_q, self._data_q,
                      self._free_q, self._shm.name, self._slot_bytes,
                      w, num_workers, seed + w, worker_init_fn),
                daemon=True,
            )
            for w in range(num_workers)
        ]
        import warnings

        with warnings.catch_warnings():
            # CPython 3.12 (DeprecationWarning) warns that fork of a
            # multithreaded process may deadlock; these children never
            # call into torch (numpy-only loop + os._exit)
            warnings.filterwarnings("ignore", message=".*fork.*")
            warnings.filterwarnings("ignore", message=".*multi-threaded.*")
            for w in self._workers:
                w.start()
        # feed: cap outstanding tasks at the slot count so workers can't
        # deadlock waiting for free slots held by unread results
        self._next_task = 0
        self._next_emit = 0
        self._pending: dict = {}
        self._closed = False
        for _ in range(min(self._n_slots, len(self._batches))):
            self._feed_one()

    def _feed_one(self):
        if self._next_task < len(self._batches):
            self._index_q.put((self._next_task, self._batches[self._next_task]))
            self._next_task += 1

    def __iter__(self):
        return self

    def __next__(self):
        if self._next_emit >= len(self._batches):
            self.close()
            raise StopIteration
        waited = 0.0
        while self._next_emit not in self._pending:
            # poll in short slices so a silently-dead worker (OOM-kill,
            # segfault, init crash) raises instead of hanging the trainer
            tick = min(self._timeout, 2.0) if self._timeout else 2.0
            try:
                kind, bidx, slot, payload = self._data_q.get(timeout=tick)
            except _queue.Empty:
                if not any(w.is_alive() for w in self._workers):
                    # give a just-flushed crash report one more chance
                    try:
                        kind, bidx, slot, payload = self._data_q.get(
                            timeout=0.5)
                    except _queue.Empty:
                        self.close()
                        raise RuntimeError(
                            "All DataLoader workers died without reporting "
                            "an error (killed? see worker logs)")
                    self._take(kind, bidx, slot, payload)
                    continue
                waited += tick
                if (waited >= 30.0
                        and not all(w.is_alive() for w in self._workers)):
                    self.close()
                    raise RuntimeError(
                        "A DataLoader worker died and its batch never "
                        "arrived (30s stall); remaining workers were alive")
                if self._timeout and waited >= self._timeout:
                    self.close()
                    raise RuntimeError(
                        f"DataLoader worker timed out after {self._timeout}s "
                        "(the DataLoader's timeout)")
                continue
            self._take(kind, bidx, slot, payload)
            self._feed_one()
        data = self._pending.pop(self._next_emit)
        self._next_emit += 1
        if isinstance(data, _WorkerError):
            self.close()
            raise RuntimeError("DataLoader worker failed:\n" + data.text)
        return self._wrap(data)

    def _take(self, kind, bidx, slot, payload):
        """File a worker's result under its batch index. A batch's error
        waits there for its turn, as Paddle's and PyTorch's loaders re-raise
        in batch order: a later batch's error that overtakes an earlier
        batch's data must not cut the epoch short. An error outside any
        batch (``worker_init_fn``) raises at once."""
        if kind == "error":
            if bidx < 0:
                self.close()
                raise RuntimeError(
                    "DataLoader worker failed:\n" + pickle.loads(payload))
            self._pending[bidx] = _WorkerError(pickle.loads(payload))
        else:
            self._pending[bidx] = self._load(kind, slot, payload)

    def _load(self, kind, slot, payload):
        """Reassemble a worker result: shm-slab arrays or pickle fallback."""
        if kind != "shm":
            skeleton, arrays = pickle.loads(payload)
            return _unflatten_arrays(skeleton, arrays)
        skeleton, offsets = pickle.loads(payload)
        arrays = []
        base = slot * self._slot_bytes

        def leaves(obj):
            if isinstance(obj, _ArrayRef):
                yield obj
            elif isinstance(obj, dict):
                for v in obj.values():
                    yield from leaves(v)
            elif isinstance(obj, (tuple, list)):
                for v in obj:
                    yield from leaves(v)

        for ref, off in zip(leaves(skeleton), offsets):
            nelems = int(np.prod(ref.shape)) if ref.shape else 1
            view = np.frombuffer(self._shm.buf, dtype=ref.dtype,
                                 count=nelems, offset=base + off)
            arrays.append(view.reshape(ref.shape).copy())
            del view
        self._free_q.put(slot)
        return _unflatten_arrays(skeleton, arrays)

    def close(self):
        if self._closed:
            return
        self._closed = True
        for _ in self._workers:
            try:
                self._index_q.put(None)
            except Exception:
                pass
        for w in self._workers:
            w.join(timeout=2.0)
            if w.is_alive():
                w.terminate()
        for q in (self._index_q, self._data_q, self._free_q):
            try:
                q.close()
                q.cancel_join_thread()
            except Exception:
                pass
        # unlink FIRST: close() can raise BufferError while a concurrent
        # _load still holds an shm view (e.g. a prefetch thread racing an
        # abandoned-epoch teardown); the segment must still be unlinked or
        # /dev/shm leaks a slab per abandoned iterator
        try:
            self._shm.unlink()
        except Exception:
            pass
        try:
            self._shm.close()
        except Exception:
            pass

    def __del__(self):
        self.close()
