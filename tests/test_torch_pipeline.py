"""The port's pipeline parallelism (``parallel/pipeline.py``, ``zero_bubble.py``,
``pp_layers.py``), activation sharding and ``shard_map`` on the CPU.

One 4-rank gloo job (``test_torch_parallel.run_parts``) runs every
multi-process case: ``PipelineTrainStep`` at pp 2 (its fsdp 2 ranks
replicas) with ``1f1b``, ``fthenb``, ``vpp`` (R 2, M 4) and ``zb``, at pp 2
x dp 2, with a tied embedding, ``gather_params_to_model``, ``fleet`` with
``pp_degree=2``, and the DTensor cases of ``activation_sharding`` and
``shard_map``. The references are JAX's ``PipelineTrainStep`` on its 8
virtual CPU devices with the same weights (``tests/test_pipeline.py:27-33``'s
config, f32, 3 steps; JAX's ``1f1b`` and ``fthenb`` are one program, so one
reference serves both) and JAX's ``shard_map``, each built once in the
parent. This module's top level imports no JAX.

Tolerances: losses at JAX's own (rtol 2e-4, atol 2e-5,
``test_pipeline.py:64``); the gathered parameters within 2e-4 of JAX's
(as ``test_torch_parallel.py`` holds its sharded runs: AdamW's normalised
step carries the rounding of tiny gradients), every tensor of every case,
the tied one included, but one: with a tied embedding (its gradient the
sum of stage 0's and the head's, in another order than JAX's) the last
layer's ``mlp.down_proj.weight`` is held at 5e-4, one of its elements,
whose gradient is near zero, lying 3.26e-4 from JAX's after 3 steps (the
tensor next farthest, that layer's ``up_proj``, 8.6e-5); every rank's
bit for bit equal and, without dp (whose rows the one process sums per
micro-batch), within 1e-6 of the same schedule with its stages in one
process; ``zb`` against ``1f1b`` and ``pipeline_apply_zb`` against
``pipeline_apply`` in one process within 1e-6 (the same gradients summed
in the same order); the functional wavefront against JAX's at 1e-5
relative.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import part, run_parts

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=176,
           num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=64, dtype="float32")
STEPS, LR = 3, 1e-2
RTOL, ATOL, PARAM_ATOL = 2e-4, 2e-5, 2e-4
#: (case, parameter): its own tolerance against JAX (see the module doc)
PARAM_ATOL_OF = {("tied", "model.layers.3.mlp.down_proj.weight"): 5e-4}
#: name: (the port's mesh degrees, schedule, R, M, batch rows, tied)
CASES = {"1f1b": (dict(pp=2, fsdp=2), "1f1b", 1, 4, 4, False),
         "fthenb": (dict(pp=2, fsdp=2), "fthenb", 1, 4, 4, False),
         "vpp": (dict(pp=2, fsdp=2), "vpp", 2, 4, 4, False),
         "zb": (dict(pp=2, fsdp=2), "zb", 1, 4, 4, False),
         "pp2-dp2": (dict(pp=2, dp=2), "1f1b", 1, 4, 8, False),
         "tied": (dict(pp=2, fsdp=2), "1f1b", 1, 4, 4, True)}
#: the JAX reference of each case (fthenb is JAX's 1f1b program)
JAX_OF = {"fthenb": "1f1b"}


def _ids(rows):
    return np.random.RandomState(rows).randint(0, CFG["vocab_size"],
                                               (rows, 16))


def _port_model(state, tied):
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_state)

    m = LlamaForCausalLM(LlamaConfig(**CFG, tie_word_embeddings=tied),
                         device="cpu")
    load_paddle_tpu_state(m, state)
    return m


# ------------------------------------------------------------ the gloo job
def _pipelines(rank, world, states):
    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.optimizer import AdamW

    out = {}
    for name, (degrees, sched, R, M, rows, tied) in CASES.items():
        mesh = P.HybridMesh(**degrees)
        model = _port_model(states[tied], tied)
        step = P.PipelineTrainStep(
            model, AdamW(learning_rate=LR, parameters=model.parameters()),
            mesh, num_microbatches=M, schedule=sched, num_virtual_stages=R)
        ids = torch.from_numpy(_ids(rows))
        losses = [step(ids, ids).item() for _ in range(STEPS)]
        held = [sum(p.numel() for p in layer.parameters())
                for layer in model.model.layers]
        step.gather_params_to_model()
        out[name] = {"losses": losses, "stage": mesh.get_stage_id(),
                     "held": held,
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    # fleet: pp 2 with dp absorbing the rest, 1F1B over 4 micro-batches
    strategy = P.DistributedStrategy()
    strategy.hybrid_configs = {"pp_degree": 2, "dp_degree": -1}
    strategy.pipeline_configs = {"accumulate_steps": 4,
                                 "schedule_mode": "1F1B"}
    P.fleet.init(is_collective=True, strategy=strategy, device="cpu")
    model = _port_model(states[False], False)
    opt = P.fleet.distributed_optimizer(AdamW(
        learning_rate=LR, parameters=model.parameters()))
    dm = P.fleet.distributed_model(model)
    ids = torch.from_numpy(_ids(8))
    hcg = P.fleet.get_hybrid_communicate_group()
    out["fleet"] = {"losses": [dm.train_batch((ids, ids), opt).item()
                               for _ in range(STEPS)],
                    "hcg": (hcg.get_pipe_parallel_world_size(),
                            hcg.get_data_parallel_world_size(),
                            hcg.get_stage_id(), hcg.is_first_stage(),
                            hcg.is_last_stage()),
                    "kind": type(dm._step).__name__}
    return out


def _stage(slab, act):
    for k in range(slab["w"].shape[0]):
        act = torch.tanh(act @ slab["w"][k])
    return act


def _functional(rank, world, ws, x):
    """``pipeline_apply`` and ``pipeline_apply_zb`` with one stage a rank
    (pp 4): the outputs, and the gradients every rank gets."""
    from paddle_tpu_torch import parallel as P

    mesh = P.HybridMesh(pp=4)
    out = {}
    for fn in (P.pipeline_apply, P.pipeline_apply_zb):
        stacked = {k: v.requires_grad_() for k, v in P.stack_layer_params(
            [{"w": torch.from_numpy(w)} for w in ws], 1, 4).items()}
        xt = torch.from_numpy(x).requires_grad_()
        y = fn(_stage, stacked, xt, mesh=mesh)
        loss = (y ** 2).sum()
        gw, gx = torch.autograd.grad(loss, [stacked["w"], xt])
        out[fn.__name__] = (loss.item(), gw, gx)
    return out


def _layouts(rank, world, full, x4):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)

    from paddle_tpu_torch import parallel as P
    from paddle_tpu_torch.parallel.sharding import P as Spec

    mesh = P.ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "tp"])
    full = torch.from_numpy(full)
    x = distribute_tensor(full, mesh.mesh, [Replicate(), Replicate()])
    out = {}
    specs = {"residual": Spec("dp", None, "tp"),
             "logits": Spec(None, ("ep", "tp")),
             "loose": Spec(Spec.UNCONSTRAINED, "tp")}
    with P.activation_sharding(mesh, specs):
        r = P.constrain(x, "residual")
        out["residual"] = (list(r.placements), r.to_local().clone(),
                           r.full_tensor().clone())
        lg = P.constrain(x, "logits")            # ep is not on the mesh
        out["logits"] = list(lg.placements)
        rows = distribute_tensor(full, mesh.mesh, [Shard(0), Replicate()])
        out["loose"] = list(P.constrain(rows, "loose").placements)
        local = torch.ones(3)
        out["local_same"] = P.constrain(local, "residual") is local
        out["unknown_same"] = P.constrain(x, "other") is x
        out["specs"] = dict(P.current_activation_specs())
    out["outside_same"] = P.constrain(x, "residual") is x
    out["after"] = P.current_activation_specs()
    # shard_map over a 1-D mesh of the 4 ranks
    line = P.ProcessMesh([0, 1, 2, 3], dim_names=["x"])
    x4 = torch.from_numpy(x4)
    per_shard = P.shard_map(lambda a: (a * 2).sum(0, keepdim=True), line,
                            in_specs=Spec("x"), out_specs=Spec("x"))
    y = per_shard(x4)
    out["shard_map"] = (isinstance(y, DTensor), y.to_local().clone(),
                        y.full_tensor().clone())
    two = P.shard_map(lambda a, b: a + b.sum(), line,
                      in_specs=(Spec("x"), Spec()), out_specs=Spec("x"))
    out["shard_map_two"] = two(distribute_tensor(x4, line.mesh, [Shard(0)]),
                               x4[:1]).full_tensor().clone()
    return out


# --------------------------------------------------------- JAX references
def _jax_run(name):
    """JAX's PipelineTrainStep on its 8 virtual devices: the initial
    weights, the losses and the gathered weights."""
    import paddle_tpu as paddle
    import paddle_tpu.optimizer as jopt
    from paddle_tpu.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu.parallel import HybridMesh, PipelineTrainStep

    degrees, sched, R, M, rows, tied = CASES[name]
    dp = degrees.get("dp", 1)
    paddle.seed(7)
    jm = LlamaForCausalLM(LlamaConfig(**CFG, tie_word_embeddings=tied))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    hm = HybridMesh(pp=2, dp=dp, fsdp=8 // (2 * dp))
    step = PipelineTrainStep(jm, jopt.AdamW(
        learning_rate=LR, parameters=jm.parameters()), hm.mesh,
        num_microbatches=M, schedule=sched, num_virtual_stages=R)
    ids = paddle.to_tensor(_ids(rows))
    losses = [float(step(ids, ids)) for _ in range(STEPS)]
    step.gather_params_to_model()
    final = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    return state, losses, final


@pytest.fixture(scope="module")
def jax_runs():
    return {n: _jax_run(n) for n in CASES if n not in JAX_OF}


def _jax_layouts():
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as JP

    from paddle_tpu.parallel import shard_map

    rng = np.random.RandomState(5)
    full = rng.standard_normal((4, 6, 8)).astype(np.float32)
    x4 = rng.standard_normal((8, 3)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("x",))
    y = shard_map(lambda a: (a * 2).sum(0, keepdims=True), mesh,
                  in_specs=JP("x"), out_specs=JP("x"))(jnp.asarray(x4))
    y2 = shard_map(lambda a, b: a + b.sum(), mesh,
                   in_specs=(JP("x"), JP()), out_specs=JP("x"))(
        jnp.asarray(x4), jnp.asarray(x4[:1]))
    return full, x4, np.asarray(y), np.asarray(y2)


@pytest.fixture(scope="module")
def layouts_ref():
    return _jax_layouts()


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_runs, layouts_ref):
    states = {False: jax_runs["1f1b"][0], True: jax_runs["tied"][0]}
    full, x4 = layouts_ref[:2]
    ws, x = _wavefront_inputs()
    return run_parts([("pipelines", _pipelines, (states,)),
                      ("functional", _functional, (ws, x)),
                      ("layouts", _layouts, (full, x4))],
                     4, tmp_path_factory.mktemp("pipeline4"))


def _wavefront_inputs():
    """``test_pipeline.py:80-117``'s case: 8 layers of 8 x 8 weights over 4
    stages, 6 micro-batches of 2 rows."""
    rng = np.random.RandomState(0)
    ws = [rng.randn(8, 8).astype(np.float32) * 0.3 for _ in range(8)]
    return ws, rng.randn(6, 2, 8).astype(np.float32)


@pytest.fixture(scope="module")
def wavefront_ref():
    """JAX's ``pipeline_apply`` over 4 of its virtual devices: the loss and
    the gradients of the stacked weights and of the input."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from paddle_tpu.parallel.pipeline import pipeline_apply as jax_apply
    from paddle_tpu.parallel.pipeline import stack_layer_params as jax_stack

    ws, x = _wavefront_inputs()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("pp",))

    def jstage(slab, act):
        out, _ = jax.lax.scan(lambda a, wk: (jnp.tanh(a @ wk["w"]), None),
                              act, slab)
        return out

    jstacked = jax_stack([{"w": jnp.asarray(w)} for w in ws], 1, 4)
    with mesh:
        jl, jg = jax.value_and_grad(
            lambda p, xx: jnp.sum(jax_apply(jstage, p, xx, mesh=mesh,
                                            axis="pp") ** 2),
            argnums=(0, 1))(jstacked, jnp.asarray(x))
    return float(jl), np.asarray(jg[0]["w"]), np.asarray(jg[1])


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_train_step_matches_jax(world4, jax_runs, name):
    res = part(world4, "pipelines")
    want = jax_runs[JAX_OF.get(name, name)][1]
    for r in range(4):
        np.testing.assert_allclose(res[r][name]["losses"], want, rtol=RTOL,
                                   atol=ATOL, err_msg=f"rank {r}")
    degrees = CASES[name][0]
    # ranks 0, 1 (2, 3) are stage 0 (1): pp outermost in the mesh
    assert [res[r][name]["stage"] for r in range(4)] == [0, 0, 1, 1]
    assert degrees["pp"] == 2


def _in_process(name, state):
    """The case's schedule with its two stages in this process: the model
    after STEPS steps (dp folded into the micro-batches' rows)."""
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PipelineTrainStep

    degrees, sched, R, M, rows, tied = CASES[name]
    model = _port_model(state, tied)
    step = PipelineTrainStep(model, AdamW(learning_rate=LR,
                                          parameters=model.parameters()),
                             2, num_microbatches=M, schedule=sched,
                             num_virtual_stages=R)
    ids = torch.from_numpy(_ids(rows))
    losses = [step(ids, ids).item() for _ in range(STEPS)]
    return losses, dict(model.named_parameters())


def test_gather_params_to_model_matches_jax(world4, jax_runs):
    from paddle_tpu_torch.models.convert import _linear_weights

    res = part(world4, "pipelines")
    for name in ("1f1b", "zb", "pp2-dp2", "tied"):
        state, _, final = jax_runs[JAX_OF.get(name, name)]
        linear = _linear_weights(_port_model(state, CASES[name][5]))
        got = res[0][name]["params"]
        local = _in_process(name, state)[1]
        assert sorted(got) == sorted(n for n in final
                                     if "rope_" not in n)
        for n, p in got.items():
            for r in range(1, 4):
                assert torch.equal(p, res[r][name]["params"][n]), (name, n)
            if "dp" not in CASES[name][0]:      # the same arithmetic
                np.testing.assert_allclose(
                    p.numpy(), local[n].detach().numpy(), atol=1e-6,
                    err_msg=f"{name} {n} (one process)")
            w = final[n].T if n in linear else final[n]
            np.testing.assert_allclose(
                p.numpy(), w, atol=PARAM_ATOL_OF.get((name, n), PARAM_ATOL),
                err_msg=f"{name} {n}")
            assert not np.allclose(p.numpy(), state[n].T if n in linear
                                   else state[n]), (name, n)


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_hold_only_their_stages_layers(world4, name):
    """Before ``gather_params_to_model`` each rank's model holds its own
    stages' layers and none of the others' parameters (layer i runs on
    stage ``(i // K) % S``)."""
    res = part(world4, "pipelines")
    _, _, R, _, _, _ = CASES[name]
    L, S = CFG["num_hidden_layers"], 2
    K = L // (S * R)
    for r in range(4):
        held = res[r][name]["held"]
        stage = res[r][name]["stage"]
        for i, n in enumerate(held):
            assert (n > 0) == ((i // K) % S == stage), (r, i, n)


def test_fleet_pp_degree_2_matches_jax(world4, jax_runs):
    res = part(world4, "pipelines")
    want = jax_runs["pp2-dp2"][1]
    for r in range(4):
        f = res[r]["fleet"]
        np.testing.assert_allclose(f["losses"], want, rtol=RTOL, atol=ATOL)
        assert f["kind"] == "PipelineTrainStep"
        assert f["hcg"] == (2, 2, r // 2, r // 2 == 0, r // 2 == 1)


def test_activation_sharding_on_dtensors(world4, layouts_ref):
    from torch.distributed.tensor import Replicate, Shard

    full = layouts_ref[0]
    res = part(world4, "layouts")
    for r, o in enumerate(res):
        dp, tp = r // 2, r % 2
        placements, local, back = o["residual"]
        assert placements == [Shard(0), Shard(2)]
        np.testing.assert_array_equal(
            local, full[2 * dp:2 * dp + 2, :, 4 * tp:4 * tp + 4])
        np.testing.assert_array_equal(back, full)
        assert o["logits"] == [Replicate(), Shard(1)]
        assert o["loose"] == [Shard(0), Shard(1)]
        assert o["local_same"] and o["unknown_same"] and o["outside_same"]
        assert o["after"] is None
        assert o["specs"]["logits"] == (None, "tp")


def test_shard_map_matches_jax(world4, layouts_ref):
    _, x4, want, want2 = layouts_ref
    res = part(world4, "layouts")
    for r, o in enumerate(res):
        is_dt, local, full = o["shard_map"]
        assert is_dt
        np.testing.assert_allclose(local, want[r:r + 1], rtol=1e-6)
        np.testing.assert_allclose(full, want, rtol=1e-6)
        np.testing.assert_allclose(o["shard_map_two"], want2, rtol=1e-6)


# ------------------------------------------------------------- one process
@pytest.mark.parametrize("name", ["1f1b", "fthenb", "vpp", "zb", "pp2-dp2",
                                  "tied"])
def test_stages_in_one_process_match_jax(jax_runs, name):
    """The same schedules with both stages in this process (activations
    handed between list entries)."""
    state, want, _ = jax_runs[JAX_OF.get(name, name)]
    got = _in_process(name, state)[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


class _MatmulFlops(torch.utils._python_dispatch.TorchDispatchMode):
    """The floating-point operations of the matrix products run under it
    (``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 m k n each)."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.addmm.default, aten.bmm.default,
                    aten.baddbmm.default):
            a, b = args[-2], args[-1]
            self.flops += 2 * a.numel() * b.shape[-1]
        return func(*args, **(kwargs or {}))


def test_zero_bubble_gradients_equal_1f1b(jax_runs):
    """zb's deferred weight gradients against 1F1B's undivided backward,
    four stages in one process, remat off and on: the same parameters
    after two steps, and a zb step costs 1F1B's floating-point operations
    (B and W together one backward, no second walk of the graph)."""
    from paddle_tpu_torch.parallel import PipelineTrainStep
    from paddle_tpu_torch.optimizer import AdamW

    state = jax_runs["1f1b"][0]
    ids = torch.from_numpy(_ids(4))
    for remat in (False, True):
        runs, flops = {}, {}
        for sched in ("1f1b", "zb"):
            model = _port_model(state, False)
            step = PipelineTrainStep(model, AdamW(
                learning_rate=LR, parameters=model.parameters()), 4,
                num_microbatches=4, schedule=sched, remat=remat)
            with _MatmulFlops() as counter:
                first = step(ids, ids).item()
            flops[sched] = counter.flops
            runs[sched] = ([first, step(ids, ids).item()],
                           dict(model.named_parameters()))
        assert flops["zb"] == flops["1f1b"] > 0, (remat, flops)
        np.testing.assert_allclose(runs["zb"][0], runs["1f1b"][0],
                                   rtol=1e-6)
        for n, p in runs["1f1b"][1].items():
            np.testing.assert_allclose(runs["zb"][1][n].detach().numpy(),
                                       p.detach().numpy(), atol=1e-6,
                                       err_msg=n)


def test_zero_bubble_frees_its_banks(jax_runs, monkeypatch):
    """What zb's B banks (each linear's input and output gradient) is
    freed once W has used it: no banked tensor outlives the step."""
    import weakref

    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PipelineTrainStep
    from paddle_tpu_torch.parallel import pipeline as PL

    banked = []
    weight_grads = PL.LinearBank.weight_grads

    def watched(bucket):
        banked.extend(weakref.ref(t) for _, x, gy in bucket for t in (x, gy))
        return weight_grads(bucket)

    monkeypatch.setattr(PL.LinearBank, "weight_grads", staticmethod(watched))
    model = _port_model(jax_runs["1f1b"][0], False)
    step = PipelineTrainStep(model, AdamW(learning_rate=LR,
                                          parameters=model.parameters()),
                             2, num_microbatches=4, schedule="zb",
                             remat=False)
    ids = torch.from_numpy(_ids(4))
    step(ids, ids)
    L = CFG["num_hidden_layers"]
    assert len(banked) == 2 * 7 * L * 4      # x, gy of 7 linears a layer
    assert all(r() is None for r in banked)


def _check_wavefront(got, ref):
    loss, gw, gx = got
    jl, jw, jx = ref
    np.testing.assert_allclose(loss, jl, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(gw), jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gx), jx, rtol=1e-5, atol=1e-6)


def test_functional_wavefront_matches_jax(wavefront_ref):
    """``pipeline_apply`` and ``pipeline_apply_zb`` (S 4, M 6) in one
    process against JAX's ``pipeline_apply``: the loss and the gradients
    of the stacked weights and of the input (``test_pipeline.py:80-117``);
    the two backwards equal."""
    from paddle_tpu_torch.parallel import (pipeline_apply, pipeline_apply_zb,
                                           stack_layer_params)

    ws, x = _wavefront_inputs()
    got = []
    for fn in (pipeline_apply, pipeline_apply_zb):
        stacked = {k: v.requires_grad_() for k, v in stack_layer_params(
            [{"w": torch.from_numpy(w)} for w in ws], 1, 4).items()}
        xt = torch.from_numpy(x).requires_grad_()
        loss = (fn(_stage, stacked, xt) ** 2).sum()
        gw, gx = torch.autograd.grad(loss, [stacked["w"], xt])
        assert stacked["w"].shape == (1, 4, 2, 8, 8)
        _check_wavefront((loss.item(), gw, gx), wavefront_ref)
        got.append((gw, gx))
    for a, b in zip(*got):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_functional_wavefront_across_processes(world4, wavefront_ref):
    """The same with one stage a process (pp 4, point-to-point on the
    group): every rank's loss and gradients are JAX's."""
    res = part(world4, "functional")
    for r in range(4):
        for name in ("pipeline_apply", "pipeline_apply_zb"):
            _check_wavefront(res[r][name], wavefront_ref)


def test_schedules_and_their_ticks():
    """Every stage's order holds each (micro-batch, group) forward and
    backward once (and zb's weight gradients after every backward); the
    ticks keep each stage's order where its inputs have arrived, run a
    backward after its forward and after the next stage's backward, and
    1F1B's last stage alternates forward and backward."""
    from paddle_tpu_torch.parallel.pipeline import stage_orders, tick_table

    for sched, S, M, R in (("fthenb", 4, 4, 1), ("1f1b", 4, 6, 1),
                           ("zb", 3, 5, 1), ("vpp", 2, 4, 2),
                           ("vpp", 4, 6, 2), ("fthenb", 2, 3, 2)):
        orders = stage_orders(sched, S, M, R)
        want = {(k, m, p) for k in "FB" for m in range(M) for p in range(R)}
        if sched == "zb":
            want |= {("W", m, 0) for m in range(M)}
        for o in orders:
            assert sorted(o) == sorted(want) and len(o) == len(want)
        ticks = tick_table(orders, S, R)
        when = {}
        for t, tick in enumerate(ticks):
            for s, (k, m, p) in tick.items():
                when[k, m, p * S + s] = t
        V = S * R
        for (k, m, v), t in when.items():
            if k == "F" and v > 0:
                assert when["F", m, v - 1] < t
            if k == "B":
                assert when["F", m, v] < t
                if v < V - 1:
                    assert when["B", m, v + 1] < t
            if k == "W":
                assert when["B", m, v] < t
    last = [a[0] for a in stage_orders("1f1b", 4, 4)[3]]
    assert last == ["F", "B"] * 4
    assert len(tick_table(stage_orders("1f1b", 4, 8), 4)) == 2 * (8 + 3)


def test_bad_configurations_raise_as_in_jax():
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel import PipelineTrainStep

    model = LlamaForCausalLM(LlamaConfig(**CFG), device="cpu")
    opt = AdamW(parameters=model.parameters())
    six = LlamaForCausalLM(LlamaConfig(**dict(CFG, num_hidden_layers=6)),
                           device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        PipelineTrainStep(six, opt, 4, num_microbatches=4)
    with pytest.raises(ValueError, match="num_virtual_stages >= 2"):
        PipelineTrainStep(model, opt, 4, num_microbatches=4, schedule="vpp",
                          num_virtual_stages=1)
    with pytest.raises(ValueError, match="non-interleaved"):
        PipelineTrainStep(model, opt, 2, num_microbatches=4, schedule="zb",
                          num_virtual_stages=2)
    with pytest.raises(ValueError, match="unknown schedule"):
        PipelineTrainStep(model, opt, 2, num_microbatches=4,
                          schedule="gpipe")
    with pytest.raises(ValueError, match="microbatches >= pp"):
        PipelineTrainStep(model, opt, 2, num_microbatches=1, schedule="vpp",
                          num_virtual_stages=2)
    step = PipelineTrainStep(model, opt, 2, num_microbatches=3)
    ids = torch.zeros(4, 16, dtype=torch.long)
    with pytest.raises(ValueError, match="not divisible"):
        step(ids, ids)
    # pp is a mesh axis now; expert parallelism still raises by name
    from paddle_tpu_torch.parallel import HybridMesh

    with pytest.raises(NotImplementedError, match=r"expert parallelism \(ep\)"):
        HybridMesh(pp=2, ep=2)


# ----------------------------------------------------------- pp_layers
class _Block(torch.nn.Module):
    def __init__(self, h):
        super().__init__()
        self.fc = torch.nn.Linear(h, h)

    def forward(self, x):
        return torch.relu(self.fc(x))


def test_pipeline_layer_matches_jax_segmentation():
    """JAX's ``TestPipelineLayer`` cases (``test_pipeline.py:174-219``) side
    by side with the JAX ``PipelineLayer``."""
    import paddle_tpu as paddle
    from paddle_tpu import nn as jnn
    from paddle_tpu.parallel import LayerDesc as JLayerDesc
    from paddle_tpu.parallel import PipelineLayer as JPipelineLayer
    from paddle_tpu_torch.parallel import (LayerDesc, PipelineLayer,
                                           SharedLayerDesc)

    class _JBlock(jnn.Layer):
        def __init__(self, h):
            super().__init__()
            self.fc = jnn.Linear(h, h)

        def forward(self, x):
            return paddle.nn.functional.relu(self.fc(x))

    pl = PipelineLayer([LayerDesc(_Block, 16) for _ in range(10)],
                       num_stages=4)
    jl = JPipelineLayer([JLayerDesc(_JBlock, 16) for _ in range(10)],
                        num_stages=4)
    assert pl.segment_parts == jl.segment_parts == [0, 3, 6, 8, 10]
    assert len(pl.get_stage_layers(0)) == 3 and pl.stage_of_layer(7) == 2
    assert len(pl.stage_sequential(1)) == 3
    mixed = []
    for _ in range(4):
        mixed += [LayerDesc(_Block, 16), LayerDesc(torch.nn.LayerNorm, 16)]
    pl = PipelineLayer(mixed, num_stages=2, seg_method="layer:_Block")
    jmixed = []
    for _ in range(4):
        jmixed += [JLayerDesc(_JBlock, 16), JLayerDesc(jnn.LayerNorm, 16)]
    jl = JPipelineLayer(jmixed, num_stages=2, seg_method="layer:_JBlock")
    assert pl.segment_parts == jl.segment_parts
    assert type(pl.run_function[pl.segment_parts[1]]).__name__ == "_Block"
    torch.manual_seed(3)
    pl = PipelineLayer([LayerDesc(_Block, 16) for _ in range(4)],
                       num_stages=2)
    x = torch.randn(2, 16)
    ref = x
    for layer in pl.run_function:
        ref = layer(ref)
    torch.testing.assert_close(pl(x), ref, rtol=1e-6, atol=0)
    shared = PipelineLayer([SharedLayerDesc("emb", torch.nn.Linear, None, 16,
                                            16),
                            LayerDesc(_Block, 16),
                            SharedLayerDesc("emb", torch.nn.Linear, None, 16,
                                            16)], num_stages=1)
    assert shared.run_function[0].shared is shared.run_function[2].shared
    assert sum(p.numel() for p in shared.parameters()) == 2 * (16 * 16 + 16)
    pl = PipelineLayer([LayerDesc(_Block, 8) for _ in range(6)],
                       num_stages=3, seg_method=[0, 1, 3, 6])
    assert pl.segment_parts == [0, 1, 3, 6]
    with pytest.raises(ValueError):
        PipelineLayer([LayerDesc(_Block, 8) for _ in range(6)],
                      num_stages=3, seg_method=[0, 1, 6])
    with pytest.raises(TypeError):
        LayerDesc(int)
    pl = PipelineLayer([LayerDesc(_Block, 8) for _ in range(2)],
                       loss_fn=lambda out, y: ((out - y) ** 2).mean())
    assert pl.loss(torch.ones(2, 8), torch.ones(2, 8)).item() == 0.0
