"""DataLoader (the counterpart of ``paddle_tpu/io/dataloader.py``).

Two worker regimes, as in the JAX package:

  * process workers (``num_workers > 0``, ``use_shared_memory=True``,
    map-style datasets of numpy samples, the default collate): forked
    children run ``__getitem__`` and the numpy collation and hand the
    arrays to the parent through a shared-memory slab ring
    (``io/worker_pool.py``). Workers never touch torch; torch tensors are
    made in the parent.
  * thread workers (an ``IterableDataset``, samples that are not numpy, a
    custom ``collate_fn`` or ``use_shared_memory=False``): a bounded
    prefetch queue filled by a thread (``_Prefetcher``).

Batches are CPU torch tensors (``torch.from_numpy`` of the collated
arrays, so int64 token ids are ``torch.long`` where the JAX package's are
int32) unless ``places`` names a device: then every tensor of a batch is
moved there before it is handed out. Sampling and the process workers'
per-epoch seed draw from numpy's global RNG in the same places as the JAX
package's, so one ``np.random.seed`` gives both the same batches.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "default_collate_fn"]


def default_collate_fn(batch):
    """Stack samples into batched CPU torch tensors (numpy dtypes kept),
    through dicts, tuples and lists; strings stay lists."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, float, np.number, np.bool_)):
        return torch.from_numpy(np.asarray(batch))
    if isinstance(sample, (str, bytes)):
        return batch
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        transposed = list(zip(*batch))
        return type(sample)(default_collate_fn(list(col)) for col in transposed)
    return batch


def _resolve_place(places) -> Optional[torch.device]:
    """The device ``places`` names (the first of a list), or None (CPU
    batches, left where the collation made them)."""
    if isinstance(places, (list, tuple)):
        places = places[0] if places else None
    return None if places is None else torch.device(places)


def _to_place(batch, place: Optional[torch.device]):
    """Every tensor of ``batch`` (through dicts, tuples and lists) on
    ``place``; ``batch`` itself when ``place`` is None."""
    if place is None:
        return batch
    if isinstance(batch, torch.Tensor):
        return batch.to(place)
    if isinstance(batch, dict):
        return {k: _to_place(v, place) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_to_place(v, place) for v in batch)
    return batch


def _prefetch_put(q: queue.Queue, stop: threading.Event, item) -> bool:
    """Bounded put that notices consumer shutdown. Returns False if shut
    down."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _prefetch_loop(it, q, stop, done, err_box):
    # Module-level target: the thread must hold no reference to the
    # _Prefetcher itself, otherwise an abandoned iterator (`break`
    # mid-epoch) is kept alive by its own producer thread and __del__ /
    # close() never runs, pinning the thread + queued batches forever.
    try:
        for item in it:
            if not _prefetch_put(q, stop, item):
                return
    except BaseException as e:  # propagate to consumer
        err_box.append(e)
    finally:
        _prefetch_put(q, stop, done)


class _Prefetcher:
    def __init__(self, it, num_workers: int, capacity: int):
        self._source = it  # introspectable (tests check the worker backend)
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._done = object()
        self._err_box: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=_prefetch_loop,
            args=(it, self._q, self._stop, self._done, self._err_box),
            daemon=True,
        )
        self._thread.start()

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag promptly
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        # propagate: when wrapping ProcessPoolIterator, closing the
        # prefetcher must also reap worker processes + unlink the shm slab.
        # Join the producer thread first — closing a generator (thread
        # path) or pool mid-__next__ from this thread would race it.
        self._thread.join(timeout=2.0)
        src_close = getattr(self._source, "close", None)
        if callable(src_close):
            try:
                src_close()
            except ValueError:
                pass  # generator still executing after join timeout

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item


class DataLoader:
    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list: bool = True,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        use_buffer_reader: bool = True,
        prefetch_factor: int = 2,
        use_shared_memory: bool = True,
        timeout: int = 0,
        worker_init_fn: Optional[Callable] = None,
        persistent_workers: bool = False,
    ):
        self.dataset = dataset
        self.place = _resolve_place(places)
        self.collate_fn = collate_fn or default_collate_fn
        self._custom_collate = collate_fn is not None
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last
            )

    def _iter_batches(self):
        if self._iterable_mode:
            batch = []
            for sample in self.dataset:
                batch.append(sample)
                if len(batch) == self.batch_size:
                    yield self._collate(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self._collate(batch)
        else:
            for indices in self.batch_sampler:
                yield self._collate([self.dataset[i] for i in indices])

    def _collate(self, samples):
        return _to_place(self.collate_fn(samples), self.place)

    def _numpy_safe_sample(self, index) -> bool:
        """Probe one sample in the PARENT (cached): the process path requires
        numpy (or scalar/str) leaves end to end, because workers must not
        touch torch. Tensor-producing datasets fall back to thread
        workers."""
        cached = getattr(self, "_probe_ok", None)
        if cached is not None:
            return cached
        # RNG-neutral probe: datasets with random augmentation must see the
        # same parent RNG stream whether or not this probe (first epoch
        # only) ran — else epoch seeds silently differ between runs
        import random as _random

        np_state, py_state = np.random.get_state(), _random.getstate()
        try:
            sample = self.dataset[index]
        except Exception:
            self._probe_ok = False
            return False
        finally:
            np.random.set_state(np_state)
            _random.setstate(py_state)

        def ok(s):
            if isinstance(s, (np.ndarray, int, float, np.number, np.bool_,
                              str, bytes)):
                return True
            if isinstance(s, dict):
                return all(ok(v) for v in s.values())
            if isinstance(s, (tuple, list)):
                return all(ok(v) for v in s)
            return False

        self._probe_ok = ok(sample)
        return self._probe_ok

    def _wrap_np_tree(self, data):
        """numpy pytree (worker output) -> a batch of torch tensors on the
        loader's place, as default_collate_fn wraps it."""
        if isinstance(data, np.ndarray):
            return _to_place(torch.from_numpy(data), self.place)
        if isinstance(data, dict):
            return {k: self._wrap_np_tree(v) for k, v in data.items()}
        if isinstance(data, (tuple, list)):
            return type(data)(self._wrap_np_tree(v) for v in data)
        return data

    def __iter__(self):
        if (self.num_workers > 0 and self.use_shared_memory
                and not self._iterable_mode and not self._custom_collate):
            # materialise this epoch's index batches ONCE so a one-shot
            # batch_sampler iterable isn't consumed twice (probe + run)
            batches = [list(b) for b in self.batch_sampler]
            if batches and batches[0] \
                    and self._numpy_safe_sample(batches[0][0]):
                from .worker_pool import ProcessPoolIterator

                # fresh base seed per epoch, drawn from global numpy RNG so user
                # seeding makes epochs reproducible while distinct epochs
                # still see distinct augmentation streams
                base_seed = int(np.random.randint(0, 2**31 - 1))
                it = ProcessPoolIterator(
                    self.dataset, batches, self.num_workers,
                    collate_fn=None, wrap_fn=self._wrap_np_tree,
                    prefetch_factor=self.prefetch_factor, timeout=self.timeout,
                    worker_init_fn=self.worker_init_fn, seed=base_seed)
                if self.use_buffer_reader:
                    # the same prefetch stage the thread path gets
                    it = _Prefetcher(
                        it, self.num_workers,
                        capacity=max(2, self.prefetch_factor * self.num_workers))
                return iter(it)
            it = (self._collate([self.dataset[i] for i in b])
                  for b in batches)
        else:
            it = self._iter_batches()
        if self.num_workers > 0 and self.use_buffer_reader:
            it = _Prefetcher(
                it, self.num_workers, capacity=max(2, self.prefetch_factor * self.num_workers)
            )
        return iter(it)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)
