"""``paddle_tpu_torch.metric`` against ``paddle_tpu.metric`` on the same
seeded numpy: ``Accuracy`` (top-1, top-(1, 5), labels ``[n]`` and ``[n,
1]``, several updates, ``compute`` on torch tensors), ``Precision``,
``Recall`` and ``Auc`` (4095 and 7 thresholds, two-column scores) over
several updates and after ``reset``; names. Equal: the per-batch values
exactly, the accumulated ones within 1e-12 (the port's Auc sums its
trapezoids by numpy, JAX's in a Python loop)."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import metric as jm
from paddle_tpu_torch import metric as tm


def _scores(seed, n=64, c=10):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, c)).astype(np.float32),
            rng.randint(0, c, n).astype(np.int64))


@pytest.mark.parametrize("topk,label_col", [((1,), False), ((1, 5), True),
                                            ((2, 3), False)])
def test_accuracy_matches_jax(topk, label_col):
    j, t = jm.Accuracy(topk=topk), tm.Accuracy(topk=topk)
    assert t.name() == j.name()
    for seed in range(3):
        pred, lab = _scores(seed)
        if label_col:
            lab = lab[:, None]
        jc = j.compute(paddle.to_tensor(pred), paddle.to_tensor(lab))
        tc = t.compute(torch.from_numpy(pred), torch.from_numpy(lab))
        assert isinstance(tc, torch.Tensor) and tc.dtype == torch.bool
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert t.update(tc) == j.update(jc)
    np.testing.assert_allclose(t.accumulate(), j.accumulate(), rtol=1e-12)
    t.reset()
    j.reset()
    assert t.accumulate() == j.accumulate()


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    j, t = getattr(jm, cls)(), getattr(tm, cls)()
    assert t.name() == j.name()
    rng = np.random.RandomState(4)
    for _ in range(3):
        preds = rng.rand(50).astype(np.float32)
        labels = rng.randint(0, 2, 50)
        j.update(preds, labels)
        t.update(torch.from_numpy(preds), torch.from_numpy(labels))
        assert t.accumulate() == j.accumulate()
    t.reset()
    j.reset()
    assert t.accumulate() == j.accumulate() == 0.0


@pytest.mark.parametrize("num_thresholds,two_col", [(4095, False),
                                                    (7, True)])
def test_auc_matches_jax(num_thresholds, two_col):
    j = jm.Auc(num_thresholds=num_thresholds)
    t = tm.Auc(num_thresholds=num_thresholds)
    rng = np.random.RandomState(5)
    for _ in range(3):
        labels = rng.randint(0, 2, 80)
        p1 = np.clip(labels * 0.3 + rng.rand(80) * 0.7, 0, 1).astype(
            np.float32)
        preds = np.stack([1 - p1, p1], 1) if two_col else p1
        j.update(preds, labels)
        t.update(torch.from_numpy(preds), labels)
        np.testing.assert_allclose(t.accumulate(), j.accumulate(),
                                   rtol=1e-12)
    assert 0.5 < t.accumulate() < 1.0
    t.reset()
    assert t.accumulate() == 0.0


def test_bf16_predictions_reach_the_host_as_f32():
    pred, lab = _scores(9)
    t = tm.Accuracy(topk=(1, 5))
    tc = t.compute(torch.from_numpy(pred).to(torch.bfloat16),
                   torch.from_numpy(lab))
    t.update(tc)
    p = tm.Precision()
    p.update(torch.tensor([0.75, 0.25], dtype=torch.bfloat16),
             np.array([1, 1]))
    assert p.accumulate() == 1.0
