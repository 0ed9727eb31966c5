"""The port's hybrid parallelism (``paddle_tpu_torch.parallel``) on the CPU:
2 or 4 gloo processes a job, against numpy and against the JAX package on
its 8 virtual CPU devices.

Every job runs :func:`run_parts`: spawned processes (``torch.multiprocessing``,
this module imported by name, no JAX in them) meet on a ``file://`` store
under the test's ``tmp_path`` with a 60 s process-group timeout and run
one or more parts in turn; the parent joins them by one deadline, then
kills what is left and fails. Each rank saves what each part computed (or
its traceback), the parent compares. One 4-rank job serves every test of
this module (a spawn costs about 4 s). This module's top level imports no
JAX: the references are built in the parent, inside the fixtures.

Tolerances: collectives exact (integers and sums of a few f32 values),
the tiny f32 Llama's loss trajectories within 1e-5 relative of JAX's
``TrainStep`` and ``ShardedTrainStep`` (JAX's own sharded tests use 2e-3;
the port's sums run in another order: 3.2e-7 at most seen), the gathered
parameters within 2e-4 of JAX's after the run (Adam's normalised steps
carry the rounding of tiny gradients), the clip factor within 1e-6
relative.
"""

import os
import time
import traceback

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64,
            dtype="float32")
STEPS, LR, CLIP = 4, 1e-2, 1.0
LOSS_RTOL = 1e-5
DEADLINE = 60.0


# ------------------------------------------------------------------ harness
JOB_DEADLINE = 180.0


def _entry(parts, rank, world, init, outdir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    from paddle_tpu_torch.parallel import init_parallel_env

    out = {}
    try:
        init_parallel_env(init_method=init, world_size=world, rank=rank,
                          device="cpu", timeout=DEADLINE)
        for name, fn, args in parts:
            try:
                out[name] = fn(rank, world, *args)
            except Exception:
                out[name] = _Failed(traceback.format_exc())
        torch.save(out, os.path.join(outdir, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(outdir, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class _Failed(str):
    """A part's traceback, in place of its result."""


def run_parts(parts, world, tmp_path, deadline=JOB_DEADLINE):
    """Run ``parts``, a list of ``(name, fn, args)``, in turn in ``world``
    gloo processes (``fn(rank, world, *args)``); returns ``{name: [each
    rank's result]}``, where a part that raised holds its traceback (see
    :func:`part`). Fails the test when a process fails, or kills every
    process and fails when they are not done by ``deadline`` seconds."""
    import torch.multiprocessing as mp

    outdir = str(tmp_path)
    os.makedirs(outdir, exist_ok=True)
    init = f"file://{os.path.join(outdir, 'store')}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(parts, r, world, init, outdir))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
    for p in procs:
        p.join()
    names = [n for n, _, _ in parts]
    if hung:
        pytest.fail(f"{names}: {len(hung)} of {world} ranks still running "
                    f"after {deadline:.0f} s; killed")
    errs = [open(os.path.join(outdir, f)).read() for f in
            sorted(os.listdir(outdir)) if f.startswith("err")]
    if errs or any(p.exitcode for p in procs):
        pytest.fail(f"{names} failed:\n" + "\n".join(errs))
    outs = [torch.load(os.path.join(outdir, f"out{r}.pt"),
                       weights_only=False) for r in range(world)]
    return {n: [o[n] for o in outs] for n in names}


def part(results, name):
    """Every rank's result of part ``name``; fails the test with the
    traceback of a rank where it raised."""
    got = results[name]
    failed = [f"rank {r}:\n{g}" for r, g in enumerate(got)
              if isinstance(g, _Failed)]
    if failed:
        pytest.fail(f"{name} failed:\n" + "\n".join(failed))
    return got


def run_ranks(fn, world, tmp_path, *args, deadline=DEADLINE):
    """``fn(rank, world, *args)`` in ``world`` gloo processes; returns each
    rank's result (a job of one part)."""
    return part(run_parts([(fn.__name__, fn, args)], world, tmp_path,
                          deadline), fn.__name__)


# -------------------------------------------------------------- collectives
def _collectives(rank, world):
    from paddle_tpu_torch import parallel as P

    mesh = P.HybridMesh(dp=2, tp=2)
    out = {"coords": (mesh.axis_rank("dp"), mesh.axis_rank("tp")),
           "world_size": P.get_world_size(), "rank": P.get_rank()}
    x = torch.arange(4.0) + 10 * rank
    out["sum_world"] = P.all_reduce(x.clone())
    out["sum_tp"] = P.all_reduce(x.clone(), group="tp")
    out["max_dp"] = P.all_reduce(x.clone(), op=P.ReduceOp.MAX, group="dp")
    out["avg_tp"] = P.all_reduce(x.clone(), op=P.ReduceOp.AVG, group="tp")
    out["gather_tp"] = P.all_gather(x, group="tp", axis=0)
    lst = []
    P.all_gather(lst, x, group=("dp", "tp"))
    out["gather_list"] = torch.stack(lst)
    out["rs_tp"] = P.reduce_scatter(torch.arange(8.0) * (rank + 1),
                                    group="tp")
    buf = torch.empty(2)
    P.reduce_scatter(buf, [torch.full((2,), float(rank)),
                           torch.full((2,), 10.0 * rank)], group="tp")
    out["rs_list"] = buf
    out["a2a"] = P.all_to_all(torch.arange(4.0).reshape(2, 2) + 100 * rank,
                              group="tp", split_axis=0, concat_axis=1)
    y = x.clone()
    P.broadcast(y, src=3)
    out["bcast"] = y
    z = x.clone()
    P.reduce(z, dst=0)
    out["reduce"] = z if rank == 0 else None
    s = torch.empty(4)
    P.scatter(s, [torch.full((4,), float(i)) for i in range(4)]
              if rank == 1 else None, src=1)
    out["scatter"] = s
    out["objects"] = P.all_gather_object([], {"r": rank}, group="dp")
    P.barrier()
    return out


def test_collectives_and_mesh(world4):
    res = part(world4, "collectives")
    xs = [np.arange(4.0) + 10 * r for r in range(4)]
    tp_pair = lambda r: (r // 2 * 2, r // 2 * 2 + 1)  # noqa: E731
    dp_pair = lambda r: (r % 2, r % 2 + 2)            # noqa: E731
    for r, o in enumerate(res):
        assert o["coords"] == (r // 2, r % 2) and o["world_size"] == 4 \
            and o["rank"] == r
        a, b = tp_pair(r)
        np.testing.assert_array_equal(o["sum_world"], sum(xs))
        np.testing.assert_array_equal(o["sum_tp"], xs[a] + xs[b])
        np.testing.assert_array_equal(o["max_dp"],
                                      np.maximum(*[xs[i] for i in dp_pair(r)]))
        np.testing.assert_array_equal(o["avg_tp"], (xs[a] + xs[b]) / 2)
        np.testing.assert_array_equal(o["gather_tp"],
                                      np.concatenate([xs[a], xs[b]]))
        np.testing.assert_array_equal(o["gather_list"], np.stack(xs))
        full = np.arange(8.0) * (a + 1) + np.arange(8.0) * (b + 1)
        np.testing.assert_array_equal(o["rs_tp"], full[(r % 2) * 4:][:4])
        np.testing.assert_array_equal(
            o["rs_list"], [a + b] * 2 if r % 2 == 0 else [10.0 * (a + b)] * 2)
        # rank a sends row j of its [2, 2] to tp rank j
        got = np.concatenate([np.arange(4.0).reshape(2, 2)[r % 2:r % 2 + 1]
                              + 100 * src for src in (a, b)], axis=1)
        np.testing.assert_array_equal(o["a2a"], got)
        np.testing.assert_array_equal(o["bcast"], xs[3])
        np.testing.assert_array_equal(o["scatter"], [float(r)] * 4)
        assert o["objects"] == [{"r": i} for i in dp_pair(r)]
    np.testing.assert_array_equal(res[0]["reduce"], sum(xs))


# ------------------------------------------------------- DTensor placements
def _placements(rank, world):
    from paddle_tpu_torch import parallel as P

    mesh = P.ProcessMesh([[0, 1], [2, 3]], dim_names=["x", "y"])
    full = torch.arange(24.0).reshape(4, 6)
    out = {}
    t = P.shard_tensor(full, mesh, [P.Shard(0), P.Shard(1)])
    out["local"] = t.to_local()
    out["back"] = P.reshard(t, mesh, [P.Replicate(), P.Replicate()]) \
        .to_local()
    pm, pl = P.placements_of(t)
    out["placements"] = (pm.shape, pl)
    for kind in ("sum", "avg", "max"):
        p = P.shard_tensor(full, mesh, [P.Partial(kind), P.Replicate()])
        out[f"partial_{kind}"] = P.reshard(
            p, mesh, [P.Replicate(), P.Replicate()]).to_local()
    s = P.reshard(P.shard_tensor(full, mesh, [P.Shard(0), P.Replicate()]),
                  mesh, [P.Shard(1), P.Replicate()])
    out["s0_to_s1"] = s.to_local()
    d = P.dtensor_from_local(torch.full((2, 6), float(rank)), mesh,
                             [P.Shard(0), P.Partial()])
    out["from_local"] = P.reshard(d, mesh, [P.Replicate(), P.Replicate()]) \
        .to_local()
    layer = P.shard_layer(torch.nn.Linear(3, 2), mesh)
    out["layer_placements"] = P.placements_of(layer.weight)[1]
    from paddle_tpu_torch.optimizer import AdamW

    opt = P.shard_optimizer(AdamW(parameters=list(layer.parameters())), mesh)
    out["state_placements"] = P.placements_of(
        opt._init_state(layer.weight)["moment1"])[1]
    return out


def test_placements_on_dtensor(world4):
    from paddle_tpu_torch.parallel import Replicate, Shard

    res = part(world4, "placements")
    full = np.arange(24.0).reshape(4, 6)
    for r, o in enumerate(res):
        x, y = r // 2, r % 2
        np.testing.assert_array_equal(o["local"],
                                      full[2 * x:2 * x + 2, 3 * y:3 * y + 3])
        np.testing.assert_array_equal(o["back"], full)
        assert o["placements"] == ([2, 2], [Shard(0), Shard(1)])
        for kind in ("sum", "avg", "max"):
            np.testing.assert_array_equal(o[f"partial_{kind}"], full)
        np.testing.assert_array_equal(o["s0_to_s1"], full[:, 3 * x:3 * x + 3])
        # rows of mesh row x hold x's pair of ranks, summed over y
        want = np.concatenate([np.full((2, 6), 0.0 + 1), np.full((2, 6),
                                                                 2.0 + 3)])
        np.testing.assert_array_equal(o["from_local"], want)
        assert o["layer_placements"] == [Replicate(), Replicate()]
        assert o["state_placements"] == [Replicate(), Replicate()]


# ------------------------------------------------------------ DataParallel
def _data_parallel(rank, world):
    from paddle_tpu_torch import parallel as P

    P.HybridMesh(dp=world)
    torch.manual_seed(rank)              # different weights on each rank
    net = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                              torch.nn.Linear(7, 3))
    dp = P.DataParallel(net, comm_buffer_size=0)   # a bucket a parameter
    dp.sync_params_buffers()
    x = torch.from_numpy(np.random.RandomState(rank).standard_normal((4, 5))
                         .astype(np.float32))
    dp.scale_loss(dp(x).square().sum()).backward()
    dp.reduce_gradients()
    return {"params": [p.detach() for p in net.parameters()],
            "grads": [p.grad for p in net.parameters()]}


def test_data_parallel(world4):
    res = part(world4, "data_parallel")
    n = len(res)
    torch.manual_seed(0)
    net = torch.nn.Sequential(torch.nn.Linear(5, 7), torch.nn.Tanh(),
                              torch.nn.Linear(7, 3))
    for r in range(1, n):
        for p, q in zip(net.parameters(), res[r]["params"]):
            assert torch.equal(p.detach(), q)  # rank 0's weights everywhere
    for r in range(n):
        x = torch.from_numpy(np.random.RandomState(r).standard_normal(
            (4, 5)).astype(np.float32))
        (net(x).square().sum() / n).backward()
    for r in range(n):
        for p, g in zip(net.parameters(), res[r]["grads"]):
            np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=1e-6,
                                       atol=1e-7)


# ------------------------------------------------ the model-parallel clip
def _clip(rank, world, grads):
    from paddle_tpu_torch import nn as tnn
    from paddle_tpu_torch import parallel as P

    tp = P.HybridMesh(dp=2, tp=2).axis_rank("tp")
    pairs = []
    for i, g in enumerate(grads):
        p = torch.nn.Parameter(torch.zeros(1))
        g = torch.from_numpy(g)
        if i < 2:      # tp-sharded along dim i: this rank's half
            p._dist_axes = ("tp",)
            g = g.chunk(2, dim=i)[tp]
        pairs.append((p, g))
    clip = tnn.ClipGradByGlobalNorm(0.5)
    return [g for _, g in clip(pairs)]


def _clip_grads():
    rng = np.random.RandomState(3)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((4, 6), (6, 4), (6,))]


def test_clip_by_global_norm_spans_tp_shards(world4):
    from paddle_tpu_torch import nn as tnn

    grads = _clip_grads()
    res = part(world4, "clip")
    whole = tnn.ClipGradByGlobalNorm(0.5)(
        [(torch.nn.Parameter(torch.zeros(1)), torch.from_numpy(g))
         for g in grads])
    factor = whole[2][1].numpy() / grads[2]
    for r in range(4):
        np.testing.assert_allclose(res[r][2].numpy() / grads[2], factor,
                                   rtol=1e-6)
        for i in range(2):
            np.testing.assert_allclose(
                res[r][i].numpy(),
                np.split(whole[i][1].numpy(), 2, i)[r % 2], rtol=1e-6)
    assert factor.max() < 0.5      # the clip took effect


# ------------------------------------------------------ ShardedTrainStep
# (mesh degrees, ZeRO stage): each one 4-rank run of STEPS steps
SHARDED = {"dp2-tp2-stage0": (dict(dp=2, tp=2), 0),
           "dp2-fsdp2-stage1": (dict(dp=2, fsdp=2), 1),
           "fsdp2-tp2-stage2": (dict(fsdp=2, tp=2), 2),
           "fsdp2-tp2-stage3": (dict(fsdp=2, tp=2), 3),
           "fsdp4-stage3": (dict(fsdp=4), 3)}


def _port_model(state, **over):
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)

    m = LlamaForCausalLM(LlamaConfig(**TINY, **over), device="cpu")
    if state is not None:       # else the port's own seeded weights
        load_paddle_tpu_state(m, state)
    return m


def _sharded(rank, world, state, ids, cases):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.optimizer import AdamW

    out = {}
    for name in cases:
        degrees, stage = SHARDED[name]
        mesh = P.HybridMesh(**degrees)
        model = _port_model(state)
        opt = AdamW(learning_rate=LR, parameters=model.parameters())
        step = P.ShardedTrainStep(model, None, opt, mesh, stage=stage,
                                  clip_norm=CLIP)
        losses = [step(ids, ids).item() for _ in range(STEPS)]
        shapes = {n: tuple(t.shape) for n, t in step.params.items()}
        step.gather_params_to_model()
        out[name] = {"losses": losses, "shapes": shapes,
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    # fleet: the same through DistributedStrategy at stage 1, dp 2 x fsdp 2
    strategy = P.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": -1, "sharding_degree": 2}
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 1}
    P.fleet.init(is_collective=True, strategy=strategy, device="cpu")
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm, ClipGradByValue

    model = _port_model(state)
    opt = P.fleet.distributed_optimizer(AdamW(
        learning_rate=LR, parameters=model.parameters(),
        grad_clip=ClipGradByGlobalNorm(CLIP)))
    dm = P.fleet.distributed_model(model)
    out["fleet"] = {"losses": [dm.train_batch((ids, ids), opt).item()
                               for _ in range(STEPS)],
                    "hcg": (P.fleet.get_hybrid_communicate_group().topology)}
    # a clip or a scaler that the step cannot apply is refused
    refused = []
    for clip, scaler in ((ClipGradByValue(1.0), None), (None, object())):
        model = _port_model(state)
        opt = P.fleet.distributed_optimizer(AdamW(
            learning_rate=LR, parameters=model.parameters(), grad_clip=clip))
        try:
            P.fleet.distributed_model(model).train_batch((ids, ids), opt,
                                                         scaler)
        except ValueError as e:
            refused.append(str(e))
    out["fleet"]["refused"] = refused
    return out


def _jax_model():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM

    paddle.seed(0)
    return LlamaForCausalLM(LlamaConfig(**TINY))


def _jax_state(jm=None):
    """The JAX tiny Llama's weights and a batch."""
    jm = jm or _jax_model()
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    ids = np.random.RandomState(1).randint(0, TINY["vocab_size"], (8, 16))
    return state, ids


def _jax_reference():
    """The JAX tiny Llama's weights, a batch, and its TrainStep losses."""
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.jit import TrainStep

    jm = _jax_model()
    state, ids = _jax_state(jm)
    jids = paddle.to_tensor(ids)
    step = TrainStep(jm, None, jopt.AdamW(learning_rate=LR,
                                          parameters=jm.parameters()),
                     clip_norm=CLIP)
    losses = [float(step(jids, jids)) for _ in range(STEPS)]
    final = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return state, ids, losses, final


@pytest.fixture(scope="module")
def jax_reference():
    return _jax_reference()


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_reference):
    """The one 4-rank job of this module: ``{part: [each rank's result]}``."""
    state, ids = jax_reference[:2]
    return run_parts([
        ("collectives", _collectives, ()),
        ("placements", _placements, ()),
        ("data_parallel", _data_parallel, ()),
        ("clip", _clip, (_clip_grads(),)),
        ("sharded", _sharded, (state, torch.from_numpy(ids),
                               tuple(SHARDED)))],
        4, tmp_path_factory.mktemp("world4"))


@pytest.fixture(scope="module")
def sharded_runs(jax_reference, world4):
    return (*jax_reference, part(world4, "sharded"))


@pytest.mark.parametrize("name", list(SHARDED))
def test_sharded_train_step_matches_jax_train_step(sharded_runs, name):
    from paddle_tpu_torch.models.convert import _linear_weights

    state, ids, losses, final, res = sharded_runs
    for r in range(4):
        np.testing.assert_allclose(res[r][name]["losses"], losses,
                                   rtol=LOSS_RTOL, err_msg=f"rank {r}")
    degrees, stage = SHARDED[name]
    got = res[0][name]
    # every rank gathers the same parameters back, close to JAX's
    linear = _linear_weights(_port_model(state))
    for n, p in got["params"].items():
        for r in range(1, 4):
            assert torch.equal(p, res[r][name]["params"][n])
        want = final[n].T if n in linear else final[n]
        np.testing.assert_allclose(p.numpy(), want, atol=2e-4, err_msg=n)
    q = got["shapes"]["model.layers.0.self_attn.q_proj.weight"]
    shard = degrees.get("tp", 1) * (degrees.get("fsdp", 1)
                                    if stage == 3 else 1)
    assert q[0] * q[1] == 64 * 64 // shard


def test_fleet_train_batch_matches_jax(sharded_runs):
    _, _, losses, _, res = sharded_runs
    for r in range(4):
        np.testing.assert_allclose(res[r]["fleet"]["losses"], losses,
                                   rtol=LOSS_RTOL)
        assert res[r]["fleet"]["hcg"]["dp"] == 2 \
            and res[r]["fleet"]["hcg"]["fsdp"] == 2
        refused = res[r]["fleet"]["refused"]
        assert len(refused) == 2 and "ClipGradByValue" in refused[0] \
            and "GradScaler" in refused[1]


def test_sharded_train_step_matches_jax_sharded_step(sharded_runs):
    """JAX's own ShardedTrainStep (stage 3, dp 2 x fsdp 2 x tp 2 on its 8
    virtual devices) against the port's stage 3 at fsdp 2 x tp 2."""
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.parallel import HybridMesh, ShardedTrainStep

    state, ids, _, _, res = sharded_runs
    paddle.seed(0)
    jm = LlamaForCausalLM(LlamaConfig(**TINY))
    jm.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    hm = HybridMesh(dp=2, fsdp=2, tp=2)
    step = ShardedTrainStep(jm, None, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters()), hm.mesh, stage=3,
        clip_norm=CLIP)
    jids = paddle.to_tensor(ids)
    jax_losses = [float(step(jids, jids)) for _ in range(STEPS)]
    np.testing.assert_allclose(res[0]["fsdp2-tp2-stage3"]["losses"],
                               jax_losses, rtol=LOSS_RTOL)


def test_spec_for_matches_jax():
    """The port's spec resolution against JAX's at every stage for the
    Llama rules, a divisibility fallback and an override."""
    from jax.sharding import PartitionSpec as JP

    from paddle_tpu.parallel.sharding import llama_sharding_rules as jrules
    from paddle_tpu.parallel.sharding import spec_for as jspec
    from paddle_tpu_torch.parallel.sharding import (P, llama_sharding_rules,
                                                    spec_for)

    class FakeMesh:
        def __init__(self, **sizes):
            self.sizes = {a: 1 for a in ("pp", "dp", "fsdp", "sep", "ep",
                                         "tp")}
            self.sizes.update(sizes)
            self.shape = self.sizes

    def norm(spec):
        return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                     for e in spec)
    mesh = FakeMesh(fsdp=4, tp=2)
    cases = [("model.embed_tokens.weight", (1000, 64)),
             ("model.embed_tokens.weight", (128, 64)),
             ("model.layers.0.self_attn.q_proj.weight", (64, 64)),
             ("model.layers.0.mlp.down_proj.weight", (176, 64)),
             ("lm_head.weight", (64, 128)),
             ("model.norm.weight", (64,)), ("other.weight", (6, 10))]
    for stage in range(4):
        for name, shape in cases:
            ours = spec_for(name, shape, llama_sharding_rules(), stage, mesh)
            want = jspec(name, shape, jrules(), stage, mesh)
            assert norm(ours) == norm(want), (name, shape, stage)
        ours = spec_for("x.w", (8, 6), [], 3, mesh, override=P(None, "tp"))
        want = jspec("x.w", (8, 6), [], 3, mesh, override=JP(None, "tp"))
        assert norm(ours) == norm(want)


def test_parallel_exports_the_first_half_of_jax_names():
    """Every name JAX's ``parallel`` exports from the modules the port has
    (env, topology, collective, api, mp_ops, mp_layers, data_parallel,
    sharding, sequence_parallel, checkpoint, fleet, moe's layer five)."""
    import paddle_tpu.parallel as jax_parallel
    import paddle_tpu_torch.parallel as port

    later = {"spmd_rules", "SpmdInfo", "infer_spmd", "shard_map",
             "AsyncLoader", "OffloadedTrainStep", "rpc", "LayerDesc",
             "SharedLayerDesc", "PipelineLayer", "PipelineTrainStep",
             "pipeline_apply", "global_scatter", "global_gather",
             "TCPStore", "Store", "CommTask", "CommTaskManager",
             "comm_task", "barrier_with_timeout", "ElasticManager",
             "ElasticStatus", "MemorySparseTable", "ShardedSparseTable",
             "DistributedEmbedding", "RemoteShardedTable", "ps_service",
             "SparseSGDRule", "SparseAdagradRule", "SparseAdamRule",
             "pipeline_apply_zb", "Engine", "AutoTuner", "ClusterSpec",
             "ModelSpec", "TuneConfig"}
    want = [n for n in jax_parallel.__all__ if n not in later]
    missing = [n for n in want if n not in port.__all__
               or not hasattr(port, n)]
    assert not missing and len(want) == 49
