"""The port's LR schedulers against the JAX package's: every scheduler's
learning rate over 60 steps, equal exactly (both are the same Python float
arithmetic), and its state dict round trip: a fresh scheduler loaded from
the state dict at step 30 goes on with the same rates."""

import math

import pytest

import paddle_tpu.optimizer.lr as jlr
import paddle_tpu_torch.optimizer.lr as tlr

STEPS = 60

CASES = {
    "NoamDecay": lambda m: m.NoamDecay(d_model=64, warmup_steps=10,
                                       learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([10, 25, 40],
                                                 [1.0, 0.5, 0.1, 0.01]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, gamma=0.05),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, gamma=0.1),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, decay_steps=20,
                                                   end_lr=0.01, power=2.0),
    "PolynomialDecay_cycle": lambda m: m.PolynomialDecay(
        0.5, decay_steps=20, end_lr=0.01, power=1.0, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(0.3, warmup_steps=7,
                                             start_lr=0.0, end_lr=0.3),
    "LinearWarmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(3e-4, 20), 5, 0, 3e-4),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, gamma=0.9),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [10, 20, 45],
                                                 gamma=0.3),
    "StepDecay": lambda m: m.StepDecay(0.5, step_size=7, gamma=0.5),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "ReduceOnPlateau": lambda m: m.ReduceOnPlateau(
        1.0, patience=2, factor=0.5, cooldown=1, min_lr=0.01),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(
        0.5, T_max=25, eta_min=0.01),
    "CosineAnnealingWarmRestarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, T_0=8, T_mult=2, eta_min=0.001),
    "MultiplicativeDecay": lambda m: m.MultiplicativeDecay(
        0.5, lambda e: 0.97),
    "OneCycleLR": lambda m: m.OneCycleLR(0.5, total_steps=50),
    "OneCycleLR_linear": lambda m: m.OneCycleLR(
        0.5, total_steps=50, anneal_strategy="linear", phase_pct=0.4),
    "CyclicLR": lambda m: m.CyclicLR(0.01, 0.5, step_size_up=6),
    "CyclicLR_triangular2": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=5, step_size_down=9, mode="triangular2"),
    "CyclicLR_exp_range": lambda m: m.CyclicLR(
        0.01, 0.5, step_size_up=5, mode="exp_range", exp_gamma=0.97),
    "LinearLR": lambda m: m.LinearLR(0.5, total_steps=30),
    "CosineWarmup": lambda m: m.CosineWarmup(0.5, warmup_steps=10,
                                             total_steps=50, min_lr=0.01),
}


def metric(i):
    """A loss that falls, then stalls (ReduceOnPlateau's input)."""
    return max(5.0 - 0.5 * i, 1.0) + 0.01 * math.sin(i)


def advance(s, i):
    if isinstance(s, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
        s.step(metric(i))
    else:
        s.step()


def rates(s, start=0, steps=STEPS):
    out = []
    for i in range(start, steps):
        out.append(s())
        advance(s, i)
    return out


def test_every_scheduler_is_ported():
    assert sorted(tlr.__all__) == sorted(jlr.__all__)
    assert len(tlr.__all__) == 19  # the base class and 18 schedulers
    ported = {name.split("_")[0] for name in CASES}
    assert ported == set(tlr.__all__) - {"LRScheduler"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_rates_match_jax(name):
    ours, ref = CASES[name](tlr), CASES[name](jlr)
    assert rates(ours) == rates(ref)


@pytest.mark.parametrize("name", sorted(CASES))
def test_state_dict_round_trip(name):
    """The state dict at step 30 equals JAX's, and a fresh scheduler loaded
    from it gives the last 30 rates of the uninterrupted run."""
    full = rates(CASES[name](tlr))
    ours, ref = CASES[name](tlr), CASES[name](jlr)
    rates(ours, steps=30)
    rates(ref, steps=30)
    sd = ours.state_dict()
    assert sd == ref.state_dict()
    fresh = CASES[name](tlr)
    fresh.set_state_dict(dict(sd))
    assert rates(fresh, start=30) == full[30:]


def test_epoch_argument_and_errors():
    """``step(epoch)`` jumps; ``ReduceOnPlateau.step()`` without a metric
    only counts; the optimizer refuses ``set_lr`` over a scheduler."""
    import torch

    from paddle_tpu_torch.optimizer import SGD

    for m in (tlr, jlr):
        s = m.StepDecay(0.5, step_size=3, gamma=0.1)
        s.step(7)
        assert s.last_epoch == 7 and s() == pytest.approx(0.5 * 0.1 ** 2)
        r = m.ReduceOnPlateau(1.0)
        r.step()
        assert r.last_epoch == 1 and r() == 1.0
    p = torch.zeros(3, requires_grad=True)
    opt = SGD(learning_rate=tlr.ExponentialDecay(0.5, 0.9), parameters=[p],
              device="cpu")
    assert opt.get_lr() == 0.5
    opt._learning_rate.step()
    assert opt.get_lr() == 0.5 * 0.9
    with pytest.raises(RuntimeError, match="set_lr"):
        opt.set_lr(0.1)
