"""The port's optimizers against the JAX package's on the CPU.

One problem for every optimizer: parameters ``w [5, 7]`` and ``b [7]`` and
the gradients of ``0.5 * mean((x w + b - y)^2)`` computed in float64 numpy
from the current parameters, so both packages are handed the same
gradients whenever their parameters agree. 20 steps with an LR scheduler
(``ExponentialDecay``) stepped after each; every parameter and state entry
within rtol 1e-6 (atol 1e-7; f32, the same operations in the same order).
bf16 parameters with master weights compare the f32 masters at the same
tolerance and the bf16 parameters within one bf16 ulp (an f32 difference
at a rounding boundary moves the cast), and each parameter is its
master's cast bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.optimizer as jopt
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.ops.pallas.fused_adamw import fused_adamw_flat
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.ops.cuda.fused_adamw import (fused_adamw,
                                                   fused_adamw_reference)

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-7
STEPS = 20
SHAPES = {"w": (5, 7), "b": (7,)}

# name: (class in both packages, kwargs). Each gets an LRScheduler.
CASES = {
    "SGD": ("SGD", dict(weight_decay=0.01)),
    "Momentum": ("Momentum", dict(momentum=0.9, weight_decay=0.01)),
    "Momentum_nesterov": ("Momentum", dict(momentum=0.8, use_nesterov=True)),
    "Adam": ("Adam", dict(weight_decay=0.01)),
    "Adam_amsgrad": ("Adam", dict(amsgrad=True)),
    "AdamW": ("AdamW", dict(weight_decay=0.1, beta2=0.95)),
    "Adamax": ("Adamax", dict(weight_decay=0.01)),
    "Adagrad": ("Adagrad", dict(initial_accumulator_value=0.1)),
    "RMSProp": ("RMSProp", dict(momentum=0.9)),
    "RMSProp_centered": ("RMSProp", dict(centered=True, weight_decay=0.01)),
    "Adadelta": ("Adadelta", dict(rho=0.9)),
    "Lamb": ("Lamb", dict(lamb_weight_decay=0.01)),
    "Lars": ("Lars", dict(lars_coeff=0.01, lars_weight_decay=0.001)),
    "DGCMomentum": ("DGCMomentum", dict(rampup_begin_step=4, rampup_step=8,
                                        sparsity=(0.5, 0.75, 0.9))),
}
LR = {"Adagrad": 0.05, "RMSProp": 0.01, "RMSProp_centered": 0.01,
      "Adadelta": 1.0, "Lars": 0.5}
MASTER_PATHS = ("SGD", "Momentum", "Adam", "AdamW", "Adamax", "Lamb", "Lars")


class NamedParameter(torch.nn.Parameter):
    """A parameter with a ``name`` (a torch tensor's own ``name`` is its
    read-only dimension name, None)."""

    @property
    def name(self):
        return self.__dict__.get("_pname", "")

    @name.setter
    def name(self, value):
        self.__dict__["_pname"] = value


def problem(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((16, 5))
    y = rng.standard_normal((16, 7))
    params = {"w": rng.standard_normal(SHAPES["w"]).astype(np.float32) * 0.5,
              "b": rng.standard_normal(SHAPES["b"]).astype(np.float32) * 0.1}
    return x, y, params


def grads_of(x, y, w, b):
    """float64 gradients of ``0.5 * mean((x w + b - y)^2)``, as f32."""
    r = (x @ w.astype(np.float64) + b.astype(np.float64) - y) / y.size
    return {"w": (x.T @ r).astype(np.float32),
            "b": r.sum(0).astype(np.float32)}


def to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t._data if isinstance(t, JTensor) else t,
                      dtype=np.float32)


def make(case, dtype="float32", **over):
    """The JAX and the port optimizer of ``case`` over the problem's
    parameters (in ``dtype``), with an ExponentialDecay scheduler each."""
    cls, kw = CASES[case]
    kw = {**kw, **over}
    x, y, params = problem()
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jp = [JParameter(jnp.asarray(params[n]).astype(dtype), name=n)
          for n in SHAPES]
    tp = [NamedParameter(torch.from_numpy(params[n].copy()).to(tdt))
          for n in SHAPES]
    for p, n in zip(tp, SHAPES):
        p.name = n
    lr = LR.get(case, 0.02)
    jlr = jopt.lr.ExponentialDecay(lr, 0.9)
    tlr = topt.lr.ExponentialDecay(lr, 0.9)
    jkw = {k: v for k, v in kw.items() if k != "multi_precision"}
    jo = getattr(jopt, cls)(learning_rate=jlr, parameters=jp, **jkw)
    to = getattr(topt, cls)(learning_rate=tlr, parameters=tp, **kw)
    return (x, y), jp, tp, jo, to


def set_grads(xy, jp, tp):
    """Both packages' gradients, computed from the port's parameters. The
    port's are copies: ``jnp.asarray`` of an f32 array may share its memory
    (the CPU client takes a suitably aligned numpy buffer without a copy),
    so a port gradient made by ``torch.from_numpy`` of the same array and
    scaled in place would scale JAX's too."""
    g = grads_of(*xy, *[to_np(p) for p in tp])
    for p, n in zip(jp, SHAPES):
        p.grad = JTensor(jnp.asarray(g[n]).astype(p._data.dtype))
    for p, n in zip(tp, SHAPES):
        p.grad = torch.from_numpy(g[n].copy()).to(p.dtype)


def run(xy, jp, tp, jo, to, steps=STEPS, skip_at=()):
    for i in range(steps):
        set_grads(xy, jp, tp)
        if i in skip_at:
            jo._found_inf = JTensor(jnp.asarray(True))
            to._found_inf = torch.tensor(True)
        jo.step()
        to.step()
        jo._found_inf = to._found_inf = None
        jo._learning_rate.step()
        to._learning_rate.step()


def assert_state_close(jo, to, what):
    """Every state entry of the port against JAX's; the port lacks only the
    masters JAX keeps but never reads (no master path)."""
    js, ts = jo.state_dict(), to.state_dict()
    assert js["_step_count"] == ts["_step_count"]
    keys = {k for k in ts if k.startswith("p")}
    jkeys = {k for k in js if k.startswith("p")}
    missing = jkeys - keys
    assert keys <= jkeys and all(k.endswith(".master") for k in missing)
    assert not missing or type(to).__name__ not in MASTER_PATHS
    for k in keys:
        np.testing.assert_allclose(to_np(ts[k]), to_np(js[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_jax(case):
    xy, jp, tp, jo, to = make(case)
    run(xy, jp, tp, jo, to)
    for j, t, n in zip(jp, tp, SHAPES):
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {n}")
        assert not np.allclose(to_np(t), problem()[2][n])
    assert_state_close(jo, to, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_master_weights_match_jax(case):
    """bf16 parameters with ``multi_precision=True`` (set on the JAX
    optimizer as ``amp.decorate`` does where its constructor lacks the
    flag): the f32 masters and the bf16 parameters after 20 steps. An
    optimizer without a master path in JAX keeps none here."""
    xy, jp, tp, jo, to = make(case, dtype="bfloat16")
    jo._multi_precision = to._multi_precision = True
    run(xy, jp, tp, jo, to)
    cls = CASES[case][0]
    ts = to.state_dict()
    for i, (j, t) in enumerate(zip(jp, tp)):
        assert t.dtype == torch.bfloat16
        if cls in MASTER_PATHS:
            m = ts[f"p{i}.master"]
            assert m.dtype == torch.float32
            np.testing.assert_allclose(
                m.numpy(), to_np(jo._masters[id(j)]), rtol=RTOL, atol=ATOL)
            # the parameter is the master's cast
            assert torch.equal(t.detach(), m.to(torch.bfloat16))
        else:
            assert f"p{i}.master" not in ts
        # one bf16 ulp: an f32 difference at a rounding boundary
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["AdamW", "Momentum", "Lamb", "Adagrad"])
def test_found_inf_skip(case):
    """Steps 3 and 7 skipped through ``_found_inf`` (on the device): the
    parameters, state and masters are the same objects' values bit for bit
    across a skipped step, the step count still advances, and the run
    matches JAX's with the same skips."""
    xy, jp, tp, jo, to = make(case, dtype="bfloat16")
    jo._multi_precision = to._multi_precision = True
    run(xy, jp, tp, jo, to, steps=3)
    before = {k: v.clone() for k, v in to.state_dict().items()
              if isinstance(v, torch.Tensor)}
    params = [p.detach().clone() for p in tp]
    set_grads(xy, jp, tp)
    to._found_inf = torch.tensor(1, dtype=torch.int32)
    count = to._step_count
    to.step()
    to._found_inf = None
    assert to._step_count == count + 1
    after = to.state_dict()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    for p, q in zip(tp, params):
        assert torch.equal(p.detach(), q)
    # the same run against JAX, skips at steps 3 and 7
    xy, jp, tp, jo, to = make(case, dtype="bfloat16")
    jo._multi_precision = to._multi_precision = True
    run(xy, jp, tp, jo, to, steps=10, skip_at=(3, 7))
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=2 ** -7,
                                   atol=1e-6)
    assert_state_close(jo, to, case)


def _clip_inputs(dtype):
    rng = np.random.RandomState(3)
    arrays = [rng.standard_normal(s).astype(np.float32) * 3
              for s in ((4, 6), (6,), (3, 3))]
    jp = [JParameter(jnp.zeros(a.shape), name=f"p{i}")
          for i, a in enumerate(arrays)]
    tp = [torch.nn.Parameter(torch.zeros(a.shape)) for a in arrays]
    jp[2].need_clip = False
    tp[2].need_clip = False
    jg = [JTensor(jnp.asarray(a).astype(dtype)) for a in arrays]
    tg = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return list(zip(jp, jg)), list(zip(tp, tg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", ["ClipGradByValue", "ClipGradByNorm",
                                  "ClipGradByGlobalNorm"])
def test_clip_objects_match_jax(clip, dtype):
    """Each clip object on three gradients (one with ``need_clip`` False,
    which must come back as it was), in f32 and bf16: the same values
    within one ulp of the gradient's dtype (the norms sum in another order),
    in that dtype."""
    args = {"ClipGradByValue": (1.5, -0.5), "ClipGradByNorm": (2.0,),
            "ClipGradByGlobalNorm": (2.0,)}[clip]
    jpg, tpg = _clip_inputs(dtype)
    jout = getattr(jnn.clip, clip)(*args)(jpg)
    tout = getattr(tnn.clip, clip)(*args)(tpg)
    for (_, jg), (tp, tg), (_, tg0) in zip(jout, tout, tpg):
        assert tg.dtype == tg0.dtype
        np.testing.assert_allclose(
            to_np(tg), to_np(jg), atol=0,
            rtol=2.0 ** -22 if dtype == "float32" else 2.0 ** -7)
        if not getattr(tp, "need_clip", True):
            assert tg is tg0
    if clip == "ClipGradByValue":
        assert max(float(g.max()) for _, g in tout[:2]) <= 1.5


def test_grad_clip_in_optimizer_and_clip_grads_():
    """``grad_clip=ClipGradByGlobalNorm`` on AdamW: 20 steps against JAX;
    ``clip_grads_`` rewrites ``.grad`` in place of the list."""
    xy, jp, tp, jo, to = make("AdamW")
    jo._grad_clip = jnn.ClipGradByGlobalNorm(0.05)
    to._grad_clip = tnn.ClipGradByGlobalNorm(0.05)
    run(xy, jp, tp, jo, to)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    set_grads(xy, jp, tp)
    before = [p.grad.clone() for p in tp]
    tnn.clip_grads_(tp, tnn.ClipGradByGlobalNorm(1e-3))
    norm = torch.sqrt(sum(torch.sum(p.grad ** 2) for p in tp))
    assert float(norm) == pytest.approx(1e-3, rel=1e-5)
    assert all(not torch.equal(p.grad, b) for p, b in zip(tp, before))


def test_apply_decay_param_fun_matches_jax():
    """AdamW with ``apply_decay_param_fun``: the parameter named ``b`` is
    updated with weight decay 0, ``w`` with 0.1; 20 steps against JAX, then
    one step against a plain AdamW for each group from the same state."""
    fun = lambda name: name == "w"  # noqa: E731
    xy, jp, tp, jo, to = make("AdamW", apply_decay_param_fun=fun,
                              lr_ratio=lambda p: 0.5, lazy_mode=True)
    assert to._lr_ratio is not None and to._lazy_mode
    run(xy, jp, tp, jo, to)
    for j, t in zip(jp, tp):
        np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL, atol=ATOL)
    set_grads(xy, jp, tp)
    sd = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
          for k, v in to.state_dict().items()}
    plain = {}
    for wd in (0.0, 0.1):
        ps = [torch.nn.Parameter(p.detach().clone()) for p in tp]
        for p, q in zip(ps, tp):
            p.grad = q.grad.clone()
        o = topt.AdamW(learning_rate=topt.lr.ExponentialDecay(0.02, 0.9),
                       parameters=ps, weight_decay=wd, beta2=0.95)
        o.set_state_dict(sd)
        o.step()
        plain[wd] = ps
    to.step()
    assert torch.equal(tp[0], plain[0.1][0])
    assert torch.equal(tp[1], plain[0.0][1])
    assert not torch.equal(tp[1], plain[0.1][1])


def test_state_dict_round_trip_and_keys():
    """JAX's keys (``_step_count``, ``p{i}.<state>``, ``p{i}.master``,
    ``LR_Scheduler``); a fresh optimizer and scheduler loaded from the
    state dict after 10 steps run the last 10 bit for bit."""
    xy, jp, tp, jo, to = make("AdamW", dtype="bfloat16", amsgrad=True,
                              multi_precision=True)
    jo._multi_precision = True
    run(xy, jp, tp, jo, to, steps=10)
    ts, js = to.state_dict(), jo.state_dict()
    assert sorted(ts) == sorted(js)
    assert "p0.master" in ts and "p1.moment2_max" in ts
    assert ts["LR_Scheduler"] == js["LR_Scheduler"]
    saved = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
             for k, v in ts.items()}
    saved_params = [p.detach().clone() for p in tp]
    run(xy, jp, tp, jo, to, steps=10)
    _, _, tp2, _, to2 = make("AdamW", dtype="bfloat16", amsgrad=True,
                             multi_precision=True)
    with torch.no_grad():
        for p, q in zip(tp2, saved_params):
            p.copy_(q)
    to2.set_state_dict(saved)
    assert to2.get_lr() == saved["LR_Scheduler"]["last_lr"]
    for i in range(10):
        g = grads_of(*xy, *[to_np(p) for p in tp2])
        for p, n in zip(tp2, SHAPES):
            p.grad = torch.from_numpy(g[n]).to(p.dtype)
        to2.step()
        to2._learning_rate.step()
    for p, q in zip(tp, tp2):
        assert torch.equal(p, q)
    for k, v in to.state_dict().items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, to2.state_dict()[k]), k


# -- state crossing from JAX into the port (models/convert.py) ----------------

TINY = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_optimizer_state_crosses_from_jax(dtype):
    """A tiny Llama trained 3 eager steps in JAX (AdamW with amsgrad, a
    LinearWarmup, masters in bf16), its model and optimizer state carried
    into the port (``load_paddle_tpu_state``,
    ``load_paddle_tpu_optimizer_state``): the port's moments, amsgrad
    maxima and masters are JAX's transposed for every ``nn.Linear`` weight,
    bit for bit, the step count and scheduler carry, and 3 more steps in
    each package agree (loss rtol 1e-4 in f32, 2e-2 in bf16)."""
    from paddle_tpu.models import LlamaConfig as JCfg
    from paddle_tpu.models import LlamaForCausalLM as JLlama
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         load_paddle_tpu_optimizer_state,
                                         load_paddle_tpu_state)

    paddle.seed(5)
    jm = JLlama(JCfg(**TINY, dtype=dtype))
    mp = dtype == "bfloat16"
    jsched = jopt.lr.LinearWarmup(1e-2, 2, 0.0, 1e-2)
    jo = jopt.AdamW(learning_rate=jsched, parameters=jm.parameters(),
                    amsgrad=True, multi_precision=mp)
    ids = np.random.RandomState(6).randint(0, 128, (2, 16))
    jids = paddle.to_tensor(ids)
    jl = []
    for _ in range(3):
        loss, _ = jm(jids, labels=jids)
        loss.backward()
        jo.step()
        jo.clear_grad()
        jsched.step()
        jl.append(float(loss))
    tm = LlamaForCausalLM(LlamaConfig(**TINY, dtype=dtype), device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v.numpy()) for k, v in
                               jm.state_dict().items()})
    tsched = topt.lr.LinearWarmup(1e-2, 2, 0.0, 1e-2)
    to = topt.AdamW(learning_rate=tsched, parameters=tm.parameters(),
                    amsgrad=True, multi_precision=mp)
    names = [n for n, _ in jm.named_parameters()]
    jsd = {k: (np.asarray(v.numpy()) if isinstance(v, JTensor) else v)
           for k, v in jo.state_dict().items()}
    load_paddle_tpu_optimizer_state(to, tm, jsd, names)
    assert to._step_count == 3 and to.get_lr() == jo.get_lr()
    tparams = dict(tm.named_parameters())
    tindex = {id(p): i for i, p in enumerate(to._parameter_list)}
    tsd = to.state_dict()
    for key, value in jsd.items():
        if not key.startswith("p"):
            continue
        i, entry = key.split(".", 1)
        name = names[int(i[1:])]
        ours = tsd[f"p{tindex[id(tparams[name])]}.{entry}"]
        ref = np.asarray(value)
        if name.endswith("_proj.weight") or name == "lm_head.weight":
            ref = ref.T
        np.testing.assert_array_equal(to_np(ours), ref.astype(np.float32),
                                      err_msg=key)
    if mp:
        assert any(k.endswith(".master") for k in tsd)
    tids = torch.from_numpy(ids)
    tl = []
    for _ in range(3):
        loss, _ = jm(jids, labels=jids)
        loss.backward()
        jo.step()
        jo.clear_grad()
        jsched.step()
        jl.append(float(loss))
        loss, _ = tm(tids, labels=tids)
        loss.backward()
        to.step()
        to.clear_grad()
        tsched.step()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl[3:], rtol=1e-4 if dtype == "float32"
                               else 2e-2)


# -- L-BFGS --------------------------------------------------------------------

def _lbfgs_problem():
    rng = np.random.RandomState(9)
    a = rng.standard_normal((12, 6))
    h = a.T @ a / 12 + 0.5 * np.eye(6)
    c = rng.standard_normal(6)
    x0 = rng.standard_normal(6).astype(np.float32)
    return h.astype(np.float32), c.astype(np.float32), x0


@pytest.mark.parametrize("line_search", [None, "strong_wolfe"])
def test_lbfgs_matches_jax(line_search):
    """L-BFGS on a convex quadratic ``0.5 x'Hx - c'x`` (plus a quartic
    term), closure-driven, 3 outer steps of up to 5 iterations in both
    packages, then 2 steps without a closure: the losses within rtol 1e-5,
    the iterates within rtol 1e-4 and atol 2e-5 (the matrix products sum in
    another order, and the curvature pairs carry it), the minimum
    approached."""
    h, c, x0 = _lbfgs_problem()
    jx = JParameter(jnp.asarray(x0), name="x")
    tx = torch.nn.Parameter(torch.from_numpy(x0.copy()))
    lr = 1.0 if line_search else 0.5
    jo = jopt.LBFGS(learning_rate=lr, max_iter=5, history_size=4,
                    line_search_fn=line_search, parameters=[jx])
    to = topt.LBFGS(learning_rate=lr, max_iter=5, history_size=4,
                    line_search_fn=line_search, parameters=[tx])
    jh, jc = paddle.to_tensor(h), paddle.to_tensor(c)
    th, tc = torch.from_numpy(h), torch.from_numpy(c)

    def jclosure():
        jo.clear_grad()
        q = (jx * paddle.matmul(jh, jx)).sum() * 0.5 - (jc * jx).sum() \
            + 0.01 * (jx * jx * jx * jx).sum()
        q.backward()
        return q

    def tclosure():
        to.clear_grad()
        q = (tx * (th @ tx)).sum() * 0.5 - (tc * tx).sum() \
            + 0.01 * (tx ** 4).sum()
        q.backward()
        return q

    losses = []
    for _ in range(3):
        jl = float(jo.step(jclosure))
        tl = float(to.step(tclosure))
        assert tl == pytest.approx(jl, rel=1e-5)
        losses.append(tl)
        np.testing.assert_allclose(tx.detach().numpy(), to_np(jx),
                                   rtol=1e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    # the no-closure mode: one quasi-Newton step from the current .grad
    for _ in range(2):
        jclosure()
        tclosure()
        jo.step()
        to.step()
    np.testing.assert_allclose(tx.detach().numpy(), to_np(jx), rtol=1e-4,
                               atol=2e-5)


# -- DGC's quantile ----------------------------------------------------------------

@pytest.mark.parametrize("n,q", [(1, 0.5), (10, 0.999), (1000, 0.9),
                                 (4097, 0.75), (37, 0.0), (37, 1.0)])
def test_dgc_quantile_matches_jnp(n, q):
    """Within one f32 ulp: XLA's CPU code may fuse the interpolation's
    multiply and add."""
    from paddle_tpu_torch.optimizer.sgd import _quantile

    x = np.abs(np.random.RandomState(n).standard_normal(n)).astype(
        np.float32)
    ours = _quantile(torch.from_numpy(x), q)
    ref = jnp.quantile(jnp.asarray(x), jnp.asarray(q, jnp.float32))
    np.testing.assert_allclose(float(ours), float(ref), rtol=2.0 ** -23,
                               atol=0)


# -- the fused AdamW with the found-inf flag -----------------------------------------

def test_fused_adamw_reference_found_inf():
    """``fused_adamw_reference`` returns its inputs when the flag is set
    and the step otherwise; the wrapper on CPU tensors leaves the buffers
    alone bit for bit at 1, equals the plain version at 0."""
    rng = np.random.RandomState(12)
    p, g, m, v = (torch.from_numpy(rng.standard_normal(1003).astype(
        np.float32)) for _ in range(4))
    v = v.abs()
    hyper = (1e-3, 0.9, 0.95, 1e-8, 0.1, 3)
    out = fused_adamw_reference(p, g, m, v, *hyper,
                                found_inf=torch.tensor(1))
    assert all(a is b for a, b in zip(out, (p, m, v)))
    ref = fused_adamw_reference(p, g, m, v, *hyper)
    same = fused_adamw_reference(p, g, m, v, *hyper,
                                 found_inf=torch.tensor(0))
    for a, b in zip(ref, same):
        assert torch.equal(a, b)
    bufs = [t.clone() for t in (p, m, v)]
    fused_adamw(*bufs[:1], g, *bufs[1:], *hyper,
                found_inf=torch.tensor(1, dtype=torch.int32))
    for a, b in zip(bufs, (p, m, v)):
        assert torch.equal(a, b)
    fused_adamw(*bufs[:1], g, *bufs[1:], *hyper,
                found_inf=torch.tensor(0, dtype=torch.int32))
    for a, b in zip(bufs, ref):
        assert torch.equal(a, b)
    # against the TPU kernel in interpret mode, both flags
    jp, jm_, jv = fused_adamw_flat(
        jnp.asarray(p.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(m.numpy()), jnp.asarray(v.numpy()), *hyper[:5],
        jnp.int32(hyper[5]), interpret=True)
    for a, b in zip(ref, (jp, jm_, jv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_fused_adamw_optimizer_skip_and_state_dict():
    """FusedAdamW over bf16 parameters against the JAX FusedAdamW (its
    Pallas kernel in interpret mode), 4 steps with the found-inf flag set
    at step 2 (flat master, m and v unchanged bit for bit there); then its
    state dict (``_step_count``, ``flat``, ``m``, ``v``, JAX's keys) into a
    fresh optimizer over fresh parameters, which get the master's cast."""
    xy, jp, tp, _, _ = make("AdamW", dtype="bfloat16")
    jo = jopt.FusedAdamW(learning_rate=0.02, parameters=jp,
                         weight_decay=0.1)
    to = topt.FusedAdamW(learning_rate=0.02, parameters=tp,
                         weight_decay=0.1)
    for i in range(4):
        set_grads(xy, jp, tp)
        if i == 2:
            jo._found_inf = JTensor(jnp.asarray(True))
            to._found_inf = torch.tensor(True)
            before = [t.clone() for t in (to._flat, to._m, to._v)]
        jo.step()
        to.step()
        if i == 2:
            for a, b in zip(before, (to._flat, to._m, to._v)):
                assert torch.equal(a, b)
        jo._found_inf = to._found_inf = None
    for name in ("_flat", "_m", "_v"):
        np.testing.assert_allclose(getattr(to, name).numpy(),
                                   np.asarray(getattr(jo, name)), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    sd = to.state_dict()
    assert sorted(sd) == sorted(jo.state_dict()) == \
        ["_step_count", "flat", "m", "v"]
    fresh = [torch.nn.Parameter(torch.zeros_like(p)) for p in tp]
    to2 = topt.FusedAdamW(learning_rate=0.02, parameters=fresh,
                          weight_decay=0.1)
    to2.set_state_dict({k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                        for k, v in sd.items()})
    assert to2._step_count == 4
    for p, q in zip(fresh, tp):
        assert torch.equal(p, q)
    assert torch.equal(to2._m, to._m) and torch.equal(to2._v, to._v)


O2_CASES = [("AdamW", "float32", "clip"), ("AdamW", "bfloat16", "clip"),
            ("AdamW", "bfloat16", "scaler"), ("Momentum", "bfloat16", "clip"),
            ("Lamb", "float32", "scaler")]


@pytest.mark.parametrize("case,dtype,how", O2_CASES)
def test_step_under_auto_cast_o2_matches_jax(case, dtype, how):
    """``opt.step()`` (with a global-norm clip) or ``GradScaler.step`` inside
    ``auto_cast(level="O2")``: JAX's update, clip and unscale are raw array
    code its dispatcher never casts, so 20 steps match JAX's at the
    tolerances above (bf16 parameters with masters, as ``decorate`` sets
    them), as outside ``auto_cast``."""
    import paddle_tpu.amp as jamp
    from paddle_tpu_torch import amp as tamp

    xy, jp, tp, jo, to = make(case, dtype=dtype)
    if how == "clip":
        jo._grad_clip = jnn.ClipGradByGlobalNorm(0.05)
        to._grad_clip = tnn.ClipGradByGlobalNorm(0.05)
    if dtype == "bfloat16":
        jo._multi_precision = to._multi_precision = True
    js = jamp.GradScaler(init_loss_scaling=2.0 ** 10)
    ts = tamp.GradScaler(init_loss_scaling=2.0 ** 10)
    for _ in range(STEPS):
        set_grads(xy, jp, tp)
        with jamp.auto_cast(level="O2"), tamp.auto_cast(level="O2"):
            if how == "scaler":
                for p in jp:
                    p.grad = JTensor(p.grad._data * 2.0 ** 10)
                for p in tp:
                    p.grad.mul_(2.0 ** 10)
                js.step(jo)
                ts.step(to)
                js.update()
                ts.update()
            else:
                jo.step()
                to.step()
        jo._learning_rate.step()
        to._learning_rate.step()
    for j, t in zip(jp, tp):
        if dtype == "float32":
            np.testing.assert_allclose(to_np(t), to_np(j), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{case} {how}")
        else:
            np.testing.assert_allclose(to_np(t), to_np(j), rtol=2 ** -7,
                                       atol=1e-6, err_msg=f"{case} {how}")
    assert_state_close(jo, to, f"{case} {how} under O2")
