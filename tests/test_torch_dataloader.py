"""The port's ``io`` (datasets, samplers, DataLoader) against the JAX
package's on the CPU: under one ``np.random.seed`` both give the same
batches, through the thread and the forked process workers, with random
augmentation inside ``__getitem__``; worker info, error propagation, the
samplers and dataset combinators. The port's batches are torch tensors
(int64 ids as ``torch.long`` where JAX has int32); values are compared."""

import time

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio


class Tokens:
    """A map-style numpy dataset of token rows, with a label and optional
    augmentation that draws from numpy's global RNG (as a user's transform
    would)."""

    def __init__(self, n=11, seq=6, augment=False):
        self.rows = np.random.RandomState(7).randint(0, 1000, (n, seq))
        self.augment = augment

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        row = self.rows[i].copy()
        if self.augment:
            row = row + np.random.randint(0, 5, row.shape)
        return row, np.float32(i) * 0.5


def make_pair(cls_name, *args, **kw):
    return (getattr(jio, cls_name)(*args, **kw),
            getattr(tio, cls_name)(*args, **kw))


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return x


def epochs(loader, seed, n=2):
    np.random.seed(seed)
    out = []
    for _ in range(n):
        out.append([[as_np(t) for t in b] for b in loader])
    return out


def assert_same_batches(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for ba, bb in zip(ea, eb):
            for ta, tb in zip(ba, bb):
                np.testing.assert_array_equal(ta, tb)


@pytest.mark.parametrize("workers,shm", [(0, True), (2, True), (2, False)],
                         ids=["main", "process", "thread"])
@pytest.mark.parametrize("augment", [False, True])
def test_batches_match_jax(workers, shm, augment):
    """Two shuffled epochs of batch 3 (the last one short): the same
    batches, in order, from both packages under one seed; the port's are
    CPU tensors, ids ``torch.long``."""
    ds = Tokens(augment=augment)
    kw = dict(batch_size=3, shuffle=True, num_workers=workers,
              use_shared_memory=shm)
    jl, tl = jio.DataLoader(ds, **kw), tio.DataLoader(ds, **kw)
    assert len(tl) == len(jl) == 4
    ref, ours = epochs(jl, 11), epochs(tl, 11)
    assert_same_batches(ours, ref)
    assert [len(b[0]) for b in ours[0]] == [3, 3, 3, 2]
    assert not all(np.array_equal(a[0], b[0])
                   for a, b in zip(ours[0], ours[1]))
    np.random.seed(11)
    ids, label = next(iter(tl))
    assert ids.dtype == torch.long and label.dtype == torch.float32
    assert ids.device.type == "cpu"
    if workers and shm:
        from paddle_tpu_torch.io.worker_pool import ProcessPoolIterator

        assert isinstance(iter(tl)._source, ProcessPoolIterator)


def test_places_moves_batches():
    """``places`` names the device every tensor of a batch goes to (the
    first of a list); dict samples keep their keys."""

    class Dicts(tio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            return {"x": np.full(3, i, np.int64), "name": f"s{i}"}

    for places in ("cpu", ["cpu"], torch.device("cpu")):
        b = next(iter(tio.DataLoader(Dicts(), batch_size=2,
                                     places=places)))
        assert b["x"].device == torch.device("cpu")
        assert b["name"] == ["s0", "s1"]
    if not torch.cuda.is_available():
        loader = tio.DataLoader(Dicts(), batch_size=2, places="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            next(iter(loader))


class WhoAmI(tio.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        info = tio.get_worker_info()
        if info is None:
            return np.array([-1, -1, i])
        return np.array([info.id, info.num_workers, i])


def test_worker_info():
    """Inside a process worker ``get_worker_info`` gives its id and the
    worker count; in the main process it is None."""
    assert tio.get_worker_info() is None
    rows = torch.cat(list(tio.DataLoader(WhoAmI(), batch_size=2,
                                         num_workers=2)))
    assert set(rows[:, 0].tolist()) <= {0, 1}
    assert set(rows[:, 1].tolist()) == {2}
    assert rows[:, 2].tolist() == list(range(8))
    rows = torch.cat(list(tio.DataLoader(WhoAmI(), batch_size=2)))
    assert set(rows[:, 0].tolist()) == {-1}


class Broken(tio.Dataset):
    def __len__(self):
        return 9

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("bad sample 5")
        return np.array([i])


@pytest.mark.parametrize("shm", [True, False], ids=["process", "thread"])
def test_worker_errors_propagate(shm):
    """A sample that raises in a worker surfaces in the training loop: the
    process path as a RuntimeError carrying the worker's traceback, the
    thread path as the exception itself; the batches before it arrive."""
    loader = tio.DataLoader(Broken(), batch_size=2, num_workers=2,
                            use_shared_memory=shm)
    got = []
    err = RuntimeError if shm else ValueError
    with pytest.raises(err, match="bad sample 5"):
        for b in loader:
            got.append(b)
    assert len(got) == 2



class SlowFirst(Broken):
    """Sample 0 sleeps, so batch [4, 5]'s error reaches the loader before
    batch [0, 1]'s data."""

    def __getitem__(self, i):
        if i == 0:
            time.sleep(1.0)
        return super().__getitem__(i)


@pytest.mark.parametrize("shm", [True, False], ids=["process", "thread"])
def test_worker_error_waits_for_its_batch(shm):
    """A later batch's error that overtakes an earlier batch's data is
    raised in batch order: every batch before it arrives first, whole."""
    loader = tio.DataLoader(SlowFirst(), batch_size=2, num_workers=2,
                            use_shared_memory=shm)
    got = []
    err = RuntimeError if shm else ValueError
    with pytest.raises(err, match="bad sample 5"):
        for b in loader:
            got.append(b)
    assert [b.reshape(-1).tolist() for b in got] == [[0, 1], [2, 3]]

def test_iterable_and_combinators_match_jax():
    """An IterableDataset through thread workers (drop_last), ChainDataset,
    ConcatDataset, ComposeDataset, Subset, TensorDataset and random_split
    under one seed: the same items as JAX's."""

    def stream(m):
        class S(m.IterableDataset):
            def __iter__(self):
                for i in range(7):
                    yield np.array([i, i * i])
        return S()

    for m in (jio, tio):
        loader = m.DataLoader(stream(m), batch_size=3, drop_last=True,
                              num_workers=1)
        got = [as_np(b) for b in loader]
        assert [g.tolist() for g in got] == [
            [[0, 0], [1, 1], [2, 4]], [[3, 9], [4, 16], [5, 25]]]
        chain = m.ChainDataset([stream(m), stream(m)])
        assert sum(1 for _ in chain) == 14
    a, b = Tokens(n=4), Tokens(n=3)
    jc, tc = make_pair("ConcatDataset", [a, b])
    assert len(tc) == len(jc) == 7
    for i in range(-7, 7):
        np.testing.assert_array_equal(tc[i][0], jc[i][0])
    jc, tc = make_pair("ComposeDataset", [a, b])
    assert len(tc) == 3 and len(tc[1]) == len(jc[1]) == 4
    arrays = [np.arange(10), np.arange(10) * 2.0]
    jt, tt = make_pair("TensorDataset", arrays)
    assert tt[3] == jt[3] == (3, 6.0)
    for lengths in ([6, 5], [0.5, 0.3, 0.2]):
        np.random.seed(3)
        js = jio.random_split(Tokens(), lengths)
        np.random.seed(3)
        ts = tio.random_split(Tokens(), lengths)
        assert [s.indices for s in ts] == [s.indices for s in js]
    with pytest.raises(ValueError):
        tio.random_split(Tokens(), [3, 3])


def test_samplers_match_jax():
    """Every sampler's indices under one seed: Sequence, Random (with and
    without replacement), WeightedRandom, SubsetRandom, Batch and
    DistributedBatch (two ranks, padded, set_epoch reshuffles)."""
    ds = Tokens(n=10)

    def draws(make):
        out = []
        for m in (jio, tio):
            np.random.seed(5)
            out.append([list(make(m)) for _ in range(2)])
        return out

    cases = [
        lambda m: m.SequenceSampler(ds),
        lambda m: m.RandomSampler(ds),
        lambda m: m.RandomSampler(ds, replacement=True, num_samples=15),
        lambda m: m.WeightedRandomSampler([1, 2, 3, 0, 5], 8),
        lambda m: m.SubsetRandomSampler([1, 4, 6, 9]),
        lambda m: m.BatchSampler(ds, shuffle=True, batch_size=4),
        lambda m: m.BatchSampler(sampler=m.SequenceSampler(ds),
                                 batch_size=3, drop_last=True),
    ]
    for make in cases:
        ref, ours = draws(make)
        assert ours == ref
        assert len(make(tio)) == len(make(jio))
    for rank in (0, 1):
        j = jio.DistributedBatchSampler(Tokens(n=11), 2, num_replicas=2,
                                        rank=rank, shuffle=True)
        t = tio.DistributedBatchSampler(Tokens(n=11), 2, num_replicas=2,
                                        rank=rank, shuffle=True)
        assert list(t) == list(j) and len(t) == len(j) == 3
        t.set_epoch(1)
        j.set_epoch(1)
        assert list(t) == list(j)
    t = tio.DistributedBatchSampler(Tokens(n=11), 2)
    assert (t.nranks, t.local_rank) == (1, 0)
