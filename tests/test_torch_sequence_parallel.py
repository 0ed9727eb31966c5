"""The port's context parallelism on the CPU: the ring schedule
(``ops/fused/ring_attention``) and Ulysses, in one process over rotated
lists (as the card checks them) and in 4 gloo processes
(``parallel.ring_attention`` / ``ulysses_attention`` over ``sep``), against
JAX's ``ring_attention`` and ``ulysses_attention`` in ``shard_map`` on its
virtual devices and against dense attention (``flash_attn_reference`` over
the whole sequence); and the sep train step (``context_parallel=True``
under ``ShardedTrainStep`` at sep 2 and at sep 2 x tp 2) against JAX's
dense ``TrainStep``, with the trained model then evaluated on whole
sequences outside the step against the same weights without context
parallelism. Shards are equal; 16 rows (a block multiple) and 13 rows (not
one). The gloo parts share one 4-rank job.

Tolerances (f32): outputs and gradients within 2e-5 (JAX's own ring tests
use 2e-5 and 5e-5), lse within 2e-5, the train step's losses within 1e-5
relative.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import TINY, part, run_parts

TOL = 2e-5
N = 4


def _inputs(seed, b, s, hq, hk, d):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hk, hk)]


def _dense(q, k, v, causal):
    """Dense attention over the whole sequence: out, lse and (q, k, v)
    gradients of ``(out * w).sum()`` for a fixed w."""
    from paddle_tpu_torch.ops.fused.flash_attention import \
        flash_attn_reference

    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attn_reference(q, k, v, causal=causal, return_lse=True)
    w = torch.from_numpy(np.random.RandomState(9).standard_normal(
        out.shape).astype(np.float32))
    (out * w).sum().backward()
    return out.detach(), lse.detach(), (q.grad, k.grad, v.grad), w


def _jax_ring(q, k, v, causal, w, ulysses=False):
    """JAX's ring (or Ulysses) attention over 'sep' of 4 in shard_map: the
    output, and with ``w`` the gradients of ``(out * w).sum()``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.parallel import HybridMesh, shard_map
    from paddle_tpu.parallel.sequence_parallel import (ring_attention,
                                                       ulysses_attention)

    fn = ulysses_attention if ulysses else ring_attention
    hm = HybridMesh(dp=2, sep=N)
    spec = JP(None, "sep", None, None)
    attn = shard_map(lambda a, b_, c: fn(a, b_, c, axis="sep",
                                         causal=causal),
                     mesh=hm.mesh, in_specs=(spec,) * 3, out_specs=spec,
                     check_vma=False)
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    if w is None:
        return np.asarray(jax.jit(attn)(*args))

    def out_and_grads(*a):       # one jit: shard_map runs slowly eagerly
        out, vjp = jax.vjp(attn, *a)
        return out, vjp(jnp.asarray(w))
    out, grads = jax.jit(out_and_grads)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _ring_in_one_process(q, k, v, causal, w):
    """The schedule over every rank in one process (``rotate``), as the
    card runs it: (out, lse, (dq, dk, dv)) over the whole sequence."""
    from paddle_tpu_torch.ops.fused.ring_attention import (ring_flash_bwd,
                                                           ring_flash_fwd,
                                                           rotate)

    split = lambda a: list(torch.from_numpy(a).chunk(N, dim=1))  # noqa: E731
    qs, ks, vs = split(q), split(k), split(v)
    outs, lses = ring_flash_fwd(qs, ks, vs, list(range(N)), N, rotate, causal)
    grads = ring_flash_bwd(qs, ks, vs, outs, lses, list(w.chunk(N, dim=1)),
                           list(range(N)), N, rotate, causal)
    return (torch.cat(outs, 1), torch.cat(lses, 2),
            [torch.cat(g, 1) for g in grads])


@pytest.mark.parametrize("s_shard", [16, 13])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_schedule_in_one_process(causal, s_shard):
    q, k, v = _inputs(1, 2, N * s_shard, 4, 2, 16)
    out, lse, grads, w = _dense(q, k, v, causal)
    o, l, g = _ring_in_one_process(q, k, v, causal, w)
    np.testing.assert_allclose(o.numpy(), out.numpy(), atol=TOL)
    np.testing.assert_allclose(l.numpy(), lse.numpy(), atol=TOL)
    for got, want in zip(g, grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def test_ring_and_ulysses_match_jax():
    """At 13 rows a shard (no block multiple), causal GQA: the ring's
    output and gradients against JAX's ring attention, Ulysses' output
    against JAX's (``jax.grad`` through JAX's Ulysses fails in JAX itself:
    its all-to-all transpose mis-shapes the cotangent; the port's Ulysses
    gradients are held to dense attention in the other tests)."""
    from paddle_tpu_torch.parallel.sequence_parallel import (
        local_all_to_all, ulysses_flash)

    q, k, v = _inputs(1, 2, N * 13, 4, 2, 16)
    _, _, _, w = _dense(q, k, v, True)
    o, _, g = _ring_in_one_process(q, k, v, True, w)
    jout, jgrads = _jax_ring(q, k, v, True, w.numpy())
    np.testing.assert_allclose(o.numpy(), jout, atol=TOL)
    for got, want in zip(g, jgrads):
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    q, k, v = _inputs(2, 2, N * 8, 8, 4, 16)
    shards = [list(torch.from_numpy(a).chunk(N, dim=1)) for a in (q, k, v)]
    got = torch.cat(ulysses_flash(*shards, N, local_all_to_all), 1)
    np.testing.assert_allclose(got.numpy(), _jax_ring(q, k, v, True, None,
                                                      ulysses=True),
                               atol=TOL)


def test_ulysses_in_one_process():
    from paddle_tpu_torch.parallel.sequence_parallel import (
        local_all_to_all, ulysses_flash)

    q, k, v = _inputs(2, 2, N * 8, 8, 4, 16)
    out, _, grads, w = _dense(q, k, v, True)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    shards = [list(t.chunk(N, dim=1)) for t in ts]
    got = torch.cat(ulysses_flash(*shards, N, local_all_to_all), 1)
    np.testing.assert_allclose(got.detach().numpy(), out.numpy(), atol=TOL)
    (got * w).sum().backward()
    for t, want in zip(ts, grads):
        np.testing.assert_allclose(t.grad.numpy(), want.numpy(), atol=TOL)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_flash(*[list(torch.from_numpy(a).chunk(3, dim=1))
                        for a in (q, k, v)], 3, local_all_to_all)


def _sep_attention(rank, world, cases, w):
    from paddle_tpu_torch import parallel as P

    mesh = P.HybridMesh(sep=N)
    r = mesh.axis_rank("sep")
    out = {}
    for name, (q, k, v, causal) in cases.items():
        for kind, fn in (("ring", P.ring_attention),
                         ("ulysses", P.ulysses_attention)):
            ts = [torch.from_numpy(a).chunk(N, dim=1)[r].contiguous()
                  .requires_grad_() for a in (q, k, v)]
            o = fn(*ts, causal=causal)
            (o * w[name].chunk(N, dim=1)[r]).sum().backward()
            out[(name, kind)] = (o.detach(), [t.grad for t in ts])
    # the model's route: sep_attention is the ring on sequence shards
    # inside a sequence-sharded step, flash on whole sequences elsewhere
    q, k, v, _ = cases["causal-16"]
    ts = [torch.from_numpy(a).chunk(N, dim=1)[r] for a in (q, k, v)]
    with P.sequence_parallel.sequence_sharded():
        out["sep_attention"] = P.sep_attention(*ts, causal=True)
    out["sep_attention_whole"] = P.sep_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    return out


def _attention_cases():
    cases, refs, w = {}, {}, {}
    for name, (causal, s_shard, hk) in {"causal-16": (True, 16, 4),
                                        "causal-13": (True, 13, 8),
                                        "full-16": (False, 16, 4)}.items():
        q, k, v = _inputs(3, 1, N * s_shard, 8, hk, 16)
        cases[name] = (q, k, v, causal)
        out, _, grads, w[name] = _dense(q, k, v, causal)
        refs[name] = (out, grads)
    return cases, refs, w


@pytest.fixture(scope="module")
def sep_job(tmp_path_factory):
    """The one 4-rank job of this module, with its references: the
    attention cases and JAX's dense TrainStep."""
    from test_torch_parallel import _jax_reference

    cases, refs, w = _attention_cases()
    state, ids, losses, _ = _jax_reference()
    res = run_parts([("sep_attention", _sep_attention, (cases, w)),
                     ("sep_train", _sep_train, (state,
                                                torch.from_numpy(ids)))],
                    N, tmp_path_factory.mktemp("sep"))
    return refs, state, ids, losses, res


def test_ring_and_ulysses_across_processes(sep_job):
    refs, res = sep_job[0], part(sep_job[-1], "sep_attention")
    for name, (out, grads) in refs.items():
        for kind in ("ring", "ulysses"):
            o = torch.cat([res[r][(name, kind)][0] for r in range(N)], 1)
            np.testing.assert_allclose(o.numpy(), out.numpy(), atol=TOL,
                                       err_msg=f"{name} {kind}")
            for i, g in enumerate(grads):
                got = torch.cat([res[r][(name, kind)][1][i]
                                 for r in range(N)], 1)
                np.testing.assert_allclose(got.numpy(), g.numpy(), atol=TOL,
                                           err_msg=f"{name} {kind} d{i}")
    ring = torch.cat([res[r][("causal-16", "ring")][0] for r in range(N)], 1)
    got = torch.cat([res[r]["sep_attention"] for r in range(N)], 1)
    assert torch.equal(got, ring)
    for r in range(N):
        np.testing.assert_allclose(res[r]["sep_attention_whole"].numpy(),
                                   refs["causal-16"][0].numpy(), atol=TOL)


def _sep_train(rank, world, state, ids):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.optimizer import AdamW
    from test_torch_parallel import _port_model

    out = {}
    for name, degrees in (("sep2-tp2", dict(sep=2, tp=2)),
                          ("sep2-fsdp2", dict(sep=2, fsdp=2))):
        mesh = P.HybridMesh(**degrees)
        model = _port_model(state, context_parallel=True)
        step = P.ShardedTrainStep(model, None, AdamW(
            learning_rate=1e-2, parameters=model.parameters()), mesh,
            stage=1, clip_norm=1.0)
        out[name] = [step(ids, ids).item() for _ in range(4)]
    # the trained model outside the step, the sep 2 mesh still set: whole
    # sequences on every rank, so flash attention, not the ring
    step.gather_params_to_model()
    with torch.no_grad():
        out["outside"] = {"logits": model(ids),
                          "loss": model(ids, labels=ids)[0],
                          "params": {n: p.detach().clone()
                                     for n, p in model.named_parameters()}}
    # a mask cannot span the shards inside a sequence-sharded step
    seg = torch.zeros_like(ids)
    with P.sequence_parallel.sequence_sharded(), torch.no_grad():
        try:
            model(ids, labels=ids, segment_ids=seg)
            out["mask_inside"] = None
        except ValueError as e:
            out["mask_inside"] = str(e)
    return out


def test_sep_train_step_matches_dense(sep_job):
    _, _, ids, losses, res = sep_job
    res = part(res, "sep_train")
    for r in range(4):
        for name in ("sep2-tp2", "sep2-fsdp2"):
            np.testing.assert_allclose(res[r][name], losses, rtol=1e-5,
                                       err_msg=f"{name} rank {r}")
    assert TINY["max_position_embeddings"] >= ids.shape[1]


def test_context_parallel_model_outside_the_step_is_dense(sep_job):
    """After a sep 2 run, ``model(ids)`` and ``model(ids, labels=ids)``
    outside the step attend over the whole sequence on every rank: equal
    to the same weights without context parallelism, within 1e-6
    relative; a mask inside a sequence-sharded step raises."""
    from test_torch_parallel import _port_model

    _, state, ids, _, res = sep_job
    res = part(res, "sep_train")
    dense = _port_model(state)
    with torch.no_grad():
        for n, p in dense.named_parameters():
            p.copy_(res[0]["outside"]["params"][n])
        ids = torch.from_numpy(ids)
        logits, loss = dense(ids), dense(ids, labels=ids)[0]
    for r in range(4):
        got = res[r]["outside"]
        np.testing.assert_allclose(got["logits"].numpy(), logits.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["loss"].item(), loss.item(),
                                   rtol=1e-6)
        assert "causal-only" in res[r]["mask_inside"]
