"""Pipeline parallelism over the mesh's ``pp`` axis (the counterpart of
``paddle_tpu/parallel/pipeline.py``): ``stack_layer_params``,
``pipeline_apply`` and ``PipelineTrainStep`` with the schedules ``fthenb``,
``1f1b``, ``vpp`` / ``interleaved`` (R virtual stages a rank) and ``zb`` /
``zbh1`` (``zero_bubble.py``).

The JAX package runs the whole pipeline as one SPMD program, a scan whose
carried activation hops stages by ``ppermute``. The port runs one stage a
process (or every stage in one process) and writes the schedule once, over
the stages a process holds and an exchange, as ``ops/fused/ring_attention``
does for the ring:

* a schedule is each stage's list of actions in order (:func:`stage_orders`):
  ``("F", m, p)``, the forward of micro-batch m through the stage's p-th
  group of layers (virtual stage ``v = p S + s``), ``("B", m, p)``, its
  backward, and with ``zb`` ``("W", m, p)``, the weight gradient deferred
  after the ring has drained (``B`` then computes the activation gradient
  and banks each linear layer's input and output gradient, and ``W`` forms
  those layers' weight gradients from the bank: one backward in all,
  :class:`LinearBank`);
* :func:`tick_table` turns the lists into ticks: in a tick every stage runs
  at most its next action whose inputs have arrived, and the activations
  (forward) and their gradients (backward) it produces arrive for the next
  tick; every process computes the same table;
* the exchange hands a tick's messages on: between processes by
  ``torch.distributed`` point-to-point on the pp group (each tick's sends
  and receives posted together, ``collective.batch_isend_irecv``), in a
  process that holds every stage from one list entry to the next.

Layer i of the model runs on virtual stage ``i // K`` (K layers a virtual
stage), stage ``(i // K) % S``: the pass-major order ``i = ((p S) + s) K +
k`` of :func:`stack_layer_params`, so a VPP stage holds JAX's layers.
``PipelineTrainStep`` runs the embedding on stage 0 and the final norm,
head and loss on the last stage, each micro-batch's loss scaled to its
share of the mean over all ``B (s - 1)`` tokens (JAX's f32 shifted
cross-entropy, ``:255-312``). The replicated parameters (embedding, final
norm, head) have their gradients summed over the pp group, so every rank
applies the same update to them, as JAX's replicated ``outer``; a tied
embedding sums its stage-0 and head gradients. Micro-batch gradients are
summed in f32 and cast to the parameter's dtype once. ``batch_axes`` (dp)
split each micro-batch's rows and sum the gradients over those axes.
``remat`` recomputes each layer in the backward. Between processes a
rank keeps only its own stages' layers (the others' parameters are
released when the step is built, and filled again by
:meth:`PipelineTrainStep.gather_params_to_model`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import collective as C

__all__ = ["stack_layer_params", "pipeline_apply", "PipelineTrainStep",
           "stage_orders", "tick_table", "SCHEDULES"]

SCHEDULES = ("fthenb", "1f1b", "vpp", "interleaved", "zb", "zbh1")

Action = Tuple[str, int, int]


def stack_layer_params(per_layer: list, num_repeats: int, num_stages: int):
    """Stack L per-layer ``{name: tensor}`` dicts into ``{name: [R, S, K,
    ...]}`` where layer ``i = ((p S) + s) K + k`` sits at (pass p, stage s,
    slot k): a micro-batch's p-th lap runs contiguous layers."""
    K = len(per_layer) // (num_repeats * num_stages)
    return {n: torch.stack([d[n] for d in per_layer]).reshape(
        (num_repeats, num_stages, K) + tuple(per_layer[0][n].shape))
        for n in per_layer[0]}


def stage_orders(schedule: str, S: int, M: int, R: int = 1
                 ) -> List[List[Action]]:
    """Each stage's actions in the order it runs them.

    ``fthenb``: every forward, then every backward. ``1f1b``: stage s runs
    ``S - s - 1`` forwards, then alternates one forward and one backward,
    then the remaining backwards. ``vpp``: the interleaved 1F1B of R groups
    of layers a stage, forwards in rounds of S micro-batches through one
    group after another, ``2 (S - s - 1) + (R - 1) S`` forwards of warm-up.
    ``zb``: 1F1B whose backwards compute the activation gradients only,
    every weight gradient after them."""
    out = []
    for s in range(S):
        if schedule == "fthenb":
            acts = [("F", m, p) for p in range(R) for m in range(M)]
            acts += [("B", m, p) for p in reversed(range(R))
                     for m in range(M)]
        elif schedule in ("1f1b", "zb"):
            warm = min(S - s - 1, M)
            acts = [("F", m, 0) for m in range(warm)]
            for i in range(M - warm):
                acts += [("F", warm + i, 0), ("B", i, 0)]
            acts += [("B", m, 0) for m in range(M - warm, M)]
            if schedule == "zb":
                acts += [("W", m, 0) for m in range(M)]
        elif schedule == "vpp":
            pairs = [(m, p) for m in range(M) for p in range(R)]
            fw = sorted(pairs, key=lambda a: (a[0] // S, a[1], a[0] % S))
            bw = sorted(pairs, key=lambda a: (a[0] // S, R - 1 - a[1],
                                              a[0] % S))
            warm = min(2 * (S - s - 1) + (R - 1) * S, M * R)
            acts = [("F",) + a for a in fw[:warm]]
            for i in range(M * R - warm):
                acts += [("F",) + fw[warm + i], ("B",) + bw[i]]
            acts += [("B",) + a for a in bw[M * R - warm:]]
        else:
            raise ValueError(f"unknown schedule {schedule!r}")
        out.append(acts)
    return out


def _message(S: int, V: int, s: int, action: Action):
    """``(key, destination stage)`` of what ``action`` on stage s sends, or
    None: a forward's activation to the next virtual stage, a backward's
    gradient to the previous one."""
    kind, m, p = action
    v = p * S + s
    if kind == "F" and v < V - 1:
        return ("act", m, v + 1), (v + 1) % S
    if kind == "B" and v > 0:
        return ("grad", m, v - 1), (v - 1) % S
    return None


def tick_table(orders: List[List[Action]], S: int, R: int = 1
               ) -> List[Dict[int, Action]]:
    """The ticks of ``orders``: ``[{stage: action}]``. A stage runs its next
    action once its input has arrived (an activation or gradient sent in an
    earlier tick, its own forward for a backward, its own backward for a
    weight gradient); when no stage's next action can run, each runs its
    first action that can."""
    V = S * R
    rest = [list(o) for o in orders]
    done, arrived, ticks = set(), set(), []

    def ready(s, action):
        kind, m, p = action
        v = p * S + s
        if kind == "F":
            return v == 0 or ("act", m, v) in arrived
        if kind == "B":
            return ("F", m, v) in done and (v == V - 1
                                            or ("grad", m, v) in arrived)
        return ("B", m, v) in done

    while any(rest):
        tick = {s: rest[s].pop(0) for s in range(S)
                if rest[s] and ready(s, rest[s][0])}
        if not tick:
            for s in range(S):
                i = next((i for i, a in enumerate(rest[s]) if ready(s, a)),
                         None)
                if i is not None:
                    tick[s] = rest[s].pop(i)
            if not tick:
                raise RuntimeError("pipeline schedule: no stage can run")
        for s, action in tick.items():
            kind, m, p = action
            done.add((kind, m, p * S + s))
            msg = _message(S, V, s, action)
            if msg is not None:
                arrived.add(msg[0])
        ticks.append(tick)
    return ticks


def local_exchange(t, tick, sends, box):
    """The exchange of a process that holds every stage: each message goes
    into the mailbox of its destination."""
    for key, _, tensor in sends:
        box[key] = tensor


class P2PExchange:
    """The exchange of one stage a process: this stage's messages to other
    stages go out, and the messages the tick table says other stages send
    here come in, all posted together on the pp group (``ranks``: the
    global rank of each stage; every message ``shape`` / ``dtype``)."""

    def __init__(self, ranks: Sequence[int], stage: int, R: int, shape,
                 dtype, device, group):
        self.ranks, self.stage, self.R = list(ranks), stage, R
        self.shape, self.dtype, self.device = tuple(shape), dtype, device
        self.group = group

    def __call__(self, t, tick, sends, box):
        S = len(self.ranks)
        out = []
        for key, dst, tensor in sends:
            if dst == self.stage:
                box[key] = tensor
            else:
                out.append((tensor, self.ranks[dst]))
        incoming = []
        for s, action in tick.items():
            msg = _message(S, S * self.R, s, action)
            if s != self.stage and msg is not None and msg[1] == self.stage:
                incoming.append((msg[0], s))
        bufs = [(torch.empty(self.shape, dtype=self.dtype,
                             device=self.device), self.ranks[s])
                for _, s in incoming]
        C.batch_isend_irecv(out, bufs, self.group)
        for (key, _), (buf, _) in zip(incoming, bufs):
            box[key] = buf


class _Tap(torch.autograd.Function):
    """The identity on a banked linear's input ``x``, saving it (so that
    ``remat`` recomputes it as it would for the weight's own gradient):
    its backward appends ``(weight, x, gy)`` to the bucket, ``gy`` the
    linear's output gradient, which a hook on the output has put in
    ``cell`` just before."""

    @staticmethod
    def forward(ctx, x, cell):
        ctx.save_for_backward(x)
        ctx.cell = cell
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gx):
        w, gy, bucket = ctx.cell
        # x detached: its graph would keep this node, and the bank, alive
        bucket.append((w, ctx.saved_tensors[0].detach(), gy))
        ctx.cell = None
        return gx, None


def _banked_forward(lin, bank, x):
    """``lin(x)`` with the weight's gradient left to the bank: the product
    runs on the detached weight (its backward forms the input gradient
    only), ``_Tap`` banks its input and the output's gradient."""
    if lin.weight.requires_grad and not x.requires_grad \
            and torch.is_grad_enabled():
        raise NotImplementedError(
            "zero bubble banks a linear's weight gradient in its input's "
            "backward: the input of a trainable linear must need a gradient")
    cell = [lin.weight, None, bank.bucket]
    y = F.linear(_Tap.apply(x, cell), lin.weight.detach(), lin.bias)
    if y.requires_grad:
        y.register_hook(lambda g: cell.__setitem__(1, g))
    return y


class LinearBank:
    """Zero bubble's split of the backward over the ``nn.Linear`` modules
    of ``modules``: while the bank is open (``with bank:``) their forwards
    bank into ``bank.bucket`` (a list the caller sets before each forward;
    the recomputation of ``remat`` runs under the bank too, and what it
    banks is not read). A backward then walks the graph once for the
    activation gradient and the other parameters, and :meth:`weight_grads`
    forms the linears' weight gradients from what it banked, with no
    second walk."""

    def __init__(self, modules):
        self.linears = [m for mod in modules for m in mod.modules()
                        if isinstance(m, nn.Linear)]
        self.weights = {id(m.weight) for m in self.linears}
        self.bucket: Optional[list] = None

    def __enter__(self):
        for lin in self.linears:
            lin.forward = partial(_banked_forward, lin, self)
        return self

    def __exit__(self, *exc):
        for lin in self.linears:
            del lin.forward
        self.bucket = None

    @staticmethod
    def weight_grads(bucket):
        """``(weight, gy^T x)`` of each banked product (the product the
        undivided backward of ``F.linear`` forms for the weight)."""
        for w, x, gy in bucket:
            yield w, gy.reshape(-1, gy.shape[-1]).t().mm(
                x.reshape(-1, x.shape[-1]))


class Runner:
    """Runs a tick table for the stages a process holds.

    ``forward(m, v, x)``: virtual stage v's work on micro-batch m (x its
    input: ``source(m)`` at v = 0, else the activation received), returning
    its output (at the last virtual stage a scalar loss or the micro-batch's
    output). ``params(v)``: the tensors whose gradients v's backward sums.
    ``last_grad(m, y)``: the cotangent of the last virtual stage's output
    (None for a scalar loss). ``first_grad(m, gx)``: receives the gradient
    of ``source(m)``. ``split``: ``B`` computes the input gradient only and
    ``W`` the weight gradients (zero bubble): with ``bank`` (a
    :class:`LinearBank`) B also computes the gradients of the parameters
    the bank does not hold and W those of its linears from what B banked;
    without it W walks the kept graph again for every parameter."""

    def __init__(self, S: int, R: int, stages: Sequence[int], exchange,
                 forward: Callable, params: Callable,
                 source: Callable = lambda m: None,
                 last_grad: Callable = lambda m, y: None,
                 first_grad: Callable = lambda m, gx: None,
                 on_output: Callable = lambda m, y: None,
                 split: bool = False, bank: Optional[LinearBank] = None):
        self.S, self.R, self.stages = S, R, list(stages)
        self.exchange, self.forward, self.params = exchange, forward, params
        self.source, self.last_grad = source, last_grad
        self.first_grad, self.on_output = first_grad, on_output
        self.split, self.bank = split, bank
        self.grads: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.saved: Dict[Tuple[int, int], list] = {}
        self.box: Dict[tuple, torch.Tensor] = {}

    def _accumulate(self, params, grads):
        for p, g in zip(params, grads):
            if g is None:
                continue
            held = self.grads.get(id(p))
            if held is None:
                self.grads[id(p)] = (p, g.float())
            else:
                held[1].add_(g.float())

    def grad_of(self, p) -> Optional[torch.Tensor]:
        """The f32 sum of ``p``'s gradients over the actions run (None if
        none touched it)."""
        held = self.grads.get(id(p))
        return None if held is None else held[1]

    def _backward(self, m, v, kind):
        V = self.S * self.R
        if kind == "W":
            x, y, gy, bucket = self.saved.pop((m, v))
            if bucket is not None:
                for w, g in LinearBank.weight_grads(bucket):
                    self._accumulate([w], [g])
                return None
            ps = self.params(v)
            self._accumulate(ps, torch.autograd.grad(y, ps, gy,
                                                     allow_unused=True))
            return None
        x, y, _, bucket = self.saved[m, v]
        gy = self.last_grad(m, y) if v == V - 1 else \
            self.box.pop(("grad", m, v))
        if self.split and bucket is not None:
            # one walk: the input's and the unbanked parameters' gradients
            ps = [p for p in self.params(v) if id(p) not in self.bank.weights]
            lead = [] if x is None else [x]
            gs = torch.autograd.grad(y, lead + ps, gy, allow_unused=True)
            gx = gs[0] if lead else None
            self._accumulate(ps, gs[len(lead):])
            self.saved[m, v] = [None, None, None, bucket]
        elif self.split:
            self.saved[m, v][2] = gy
            gx = None if x is None else torch.autograd.grad(
                y, [x], gy, retain_graph=True)[0]
        else:
            ps = self.params(v)
            lead = [] if x is None else [x]
            gs = torch.autograd.grad(y, lead + ps, gy, allow_unused=True)
            gx = gs[0] if lead else None
            self._accumulate(ps, gs[len(lead):])
            del self.saved[m, v]
        if v == 0:
            if gx is not None:
                self.first_grad(m, gx)
            return None
        return gx

    def run(self, ticks, kinds=("F", "B", "W")):
        """Run the actions of ``kinds`` in ``ticks``, exchanging after every
        tick (ticks without such an action on any stage are skipped)."""
        S, V = self.S, self.S * self.R
        for t, tick in enumerate(ticks):
            tick = {s: a for s, a in tick.items() if a[0] in kinds}
            if not tick:
                continue
            sends = []
            for s in self.stages:
                action = tick.get(s)
                if action is None:
                    continue
                kind, m, p = action
                v = p * S + s
                if kind == "F":
                    x = self.source(m) if v == 0 else \
                        self.box.pop(("act", m, v)).requires_grad_()
                    bucket = [] if self.split and self.bank else None
                    if bucket is not None:
                        self.bank.bucket = bucket
                    with torch.enable_grad():
                        y = self.forward(m, v, x)
                    if bucket is not None:
                        self.bank.bucket = None
                    self.saved[m, v] = [x, y, None, bucket]
                    if v == V - 1:
                        self.on_output(m, y)
                    else:
                        sends.append((("act", m, v + 1), (v + 1) % S,
                                      y.detach()))
                else:
                    with torch.enable_grad():
                        gx = self._backward(m, v, kind)
                    if gx is not None:
                        sends.append((("grad", m, v - 1), (v - 1) % S, gx))
            self.exchange(t, tick, sends, self.box)


def _in_process(mesh) -> bool:
    return mesh is None or isinstance(mesh, int)


class _PipelineFn(torch.autograd.Function):
    """``pipeline_apply``'s wavefront as one differentiable call: the
    forward ticks in ``forward``, the backward (and with ``split`` the
    deferred weight-gradient) ticks in ``backward``."""

    @staticmethod
    def forward(ctx, plan, x, *flat):
        names, S, R, stages = plan.names, plan.S, plan.R, plan.stages
        M = x.shape[0]
        leaves = [f.detach().requires_grad_(f.requires_grad) for f in flat]
        stacked = dict(zip(names, leaves))
        outs = torch.zeros_like(x)
        # one view a virtual stage, shared by its micro-batches' graphs
        with torch.enable_grad():
            slabs = {p * S + s: {n: t[p, s] for n, t in stacked.items()}
                     for s in stages for p in range(R)}

        def params(v):
            return [slabs[v][n] for n in names if stacked[n].requires_grad]

        def fwd(m, v, a):
            return plan.stage_fn(slabs[v], a, *plan.extras)

        def on_output(m, y):
            outs[m] = y.detach()

        runner = Runner(S, R, stages, plan.exchange, fwd, params,
                        source=lambda m: x[m].detach().requires_grad_(
                            x.requires_grad),
                        on_output=on_output, split=plan.split)
        orders = stage_orders("fthenb", S, M, R)
        if plan.split:
            orders = [o + [("W", m, 0) for m in range(M)] for o in orders]
        ticks = tick_table(orders, S, R)
        runner.run(ticks, ("F",))
        if plan.group is not None:  # the last stage's outputs to the group
            C.all_reduce(outs, group=plan.group)
        ctx.state = (plan, runner, ticks, stacked, slabs)
        return outs

    @staticmethod
    def backward(ctx, gout):
        plan, runner, ticks, stacked, slabs = ctx.state
        S = plan.S
        gx = torch.zeros_like(gout)

        def first_grad(m, g):
            gx[m] = g

        runner.last_grad = lambda m, y: gout[m]
        runner.first_grad = first_grad
        runner.run(ticks, ("B", "W"))
        # each slab's gradient into its [R, S, K, ...] stacked parameter
        grads = []
        for n in plan.names:
            t = stacked[n]
            if not t.requires_grad:
                grads.append(None)
                continue
            g = torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for v, slab in slabs.items():
                sg = runner.grad_of(slab[n])
                if sg is not None:
                    p, s = divmod(v, S)
                    g[p, s] += sg
            grads.append(g.to(t.dtype))
        if plan.group is not None:      # every rank gets the whole gradient
            for g in grads:
                if g is not None:
                    C.all_reduce(g, group=plan.group)
            C.all_reduce(gx, group=plan.group)
        ctx.state = None
        return (None, gx, *grads)


@dataclass
class _Plan:
    """What ``_PipelineFn`` runs; ``group`` is the pp axis between
    processes (None in one), ``split`` zero bubble's backward."""

    stage_fn: Callable
    names: List[str]
    extras: tuple
    S: int
    R: int
    stages: List[int]
    exchange: Any
    group: Optional[str]
    split: bool


def _apply(stage_fn, stacked_params, x_microbatches, extras, mesh, axis,
           num_repeats, split):
    names = list(stacked_params)
    first = stacked_params[names[0]]
    R = int(num_repeats)
    M = x_microbatches.shape[0]
    if _in_process(mesh):
        S = first.shape[1] if mesh is None else int(mesh)
        stages, exchange, group = list(range(S)), local_exchange, None
    else:
        S = mesh.axis_size(axis)
        me = mesh.axis_rank(axis)
        stages, group = [me], axis
        exchange = P2PExchange(mesh.group_ranks(axis), me, R,
                               x_microbatches.shape[1:],
                               x_microbatches.dtype, x_microbatches.device,
                               axis)
        # a collective every rank joins before the group's first P2P
        C.all_reduce(torch.zeros(1, device=x_microbatches.device),
                     group=axis)
    if R > 1 and M < S:
        raise ValueError(f"interleaved schedule needs microbatches >= pp "
                         f"stages: M={M} < S={S}")
    if first.shape[:2] != (R, S):
        raise ValueError(f"stacked parameters must be [R={R}, S={S}, K, "
                         f"...], got {tuple(first.shape)}")
    plan = _Plan(stage_fn, names, tuple(extras), S, R, stages, exchange,
                 group, split)
    return _PipelineFn.apply(plan, x_microbatches,
                             *[stacked_params[n] for n in names])


def pipeline_apply(stage_fn: Callable, stacked_params, x_microbatches,
                   *extras, mesh=None, axis: str = "pp",
                   num_repeats: int = 1, batch_spec=None):
    """Run the pipelined wavefront; differentiable.

    ``stage_fn(slab, act, *extras) -> act`` applies one stage's K layers
    (``slab``: ``{name: [K, ...]}``); ``stacked_params``: ``{name: [R, S, K,
    ...]}`` (:func:`stack_layer_params`); ``x_microbatches [M, mb, ...]``.
    ``mesh``: None or an int (every stage in this process: S from the
    stacked parameters, or the int), or a ``HybridMesh`` (this rank runs
    stage ``axis_rank(axis)`` of its slice, activations travel by
    point-to-point on the ``axis`` group, and the outputs, the input's and
    the stacked parameters' gradients reach every rank of the group, as
    JAX's replicated results). ``batch_spec`` is accepted for JAX's
    signature: each rank passes its own micro-batch rows. Returns ``[M, mb,
    ...]``. The backward runs every micro-batch's backward after the last
    forward (F then B)."""
    return _apply(stage_fn, stacked_params, x_microbatches, extras, mesh,
                  axis, num_repeats, split=False)


class PipelineTrainStep:
    """A pipelined training step for a decoder LM of the Llama family
    (``model.model.embed_tokens``, ``.layers``, ``.norm``, ``model.lm_loss``):
    ``step = PipelineTrainStep(model, optimizer, mesh, num_microbatches,
    schedule, num_virtual_stages, axis, batch_axes, remat, donate)``;
    ``loss = step(input_ids, labels)`` with the GLOBAL batch on every rank
    returns the global loss, on every rank.

    ``mesh``: a ``HybridMesh`` (one stage a rank: stage ``axis_rank(axis)``
    of ``axis_size(axis)``) or an int S (all S stages in this process, the
    activations handed between them). ``schedule``: ``fthenb``, ``1f1b``,
    ``vpp`` / ``interleaved`` (with ``num_virtual_stages`` R >= 2 and at
    least S micro-batches) or ``zb`` / ``zbh1`` (R = 1). The batch is cut
    into ``num_microbatches`` micro-batches of consecutive rows, each split
    again over ``batch_axes`` (default dp when it is above 1). The update is
    the optimizer's ``apply_gradients_`` on this rank's parameters (its
    stages' layers and the replicated ones), with no clip, as JAX's
    ``apply_gradients_tree``. ``donate`` is accepted for JAX's signature:
    the update is in place anyway. Between processes a rank holds only its
    stages' layers: the others' parameters are released when the step is
    built (the model is still built whole first) and filled again by
    :meth:`gather_params_to_model`."""

    def __init__(self, model, optimizer, mesh, num_microbatches: int,
                 schedule: str = "1f1b", num_virtual_stages: int = 1,
                 axis: str = "pp",
                 batch_axes: Optional[Tuple[str, ...]] = None,
                 remat: bool = True, donate: bool = True):
        if schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {schedule!r}")
        if schedule in ("vpp", "interleaved") and num_virtual_stages < 2:
            raise ValueError("vpp schedule needs num_virtual_stages >= 2")
        if schedule in ("zb", "zbh1") and num_virtual_stages != 1:
            raise ValueError("zero-bubble schedule is non-interleaved "
                             "(num_virtual_stages == 1)")
        self._model, self._opt, self._mesh = model, optimizer, mesh
        self._M = int(num_microbatches)
        self._R = int(num_virtual_stages)
        self._remat, self._axis = remat, axis
        R = self._R
        if schedule in ("zb", "zbh1"):
            self._kind, self._split = "zb", True
        elif R > 1:
            self._kind, self._split = \
                ("fthenb" if schedule == "fthenb" else "vpp"), False
        else:
            self._kind, self._split = schedule, False
        if _in_process(mesh):
            S = 1 if mesh is None else int(mesh)
            self._stages = list(range(S))
            self._batch_axes: Tuple[str, ...] = ()
        else:
            S = mesh.axis_size(axis)
            self._stages = [mesh.axis_rank(axis)]
            if batch_axes is None:
                batch_axes = tuple(a for a in ("dp",)
                                   if mesh.axis_size(a) > 1)
            self._batch_axes = tuple(batch_axes)
        self._S = S
        L = model.config.num_hidden_layers
        if L % (S * R) != 0:
            raise ValueError(f"num_hidden_layers={L} must divide evenly "
                             f"into pp={S} x virtual={R} stages")
        if R > 1 and self._M < S:
            raise ValueError(f"interleaved schedule needs microbatches >= "
                             f"pp stages: M={self._M} < S={S}")
        self._K = L // (S * R)
        core = model.model
        self._layers = core.layers
        self._embed = core.embed_tokens.weight
        self._head = model.head_weight
        self._norm = core.norm.weight
        # this rank's parameters: its virtual stages' layers, then the
        # replicated ones (a tied head is the embedding itself)
        mine, seen = [], set()
        for v in self._virtual():
            for p in self._layer_params(v):
                mine.append(p)
                seen.add(id(p))
        self._outer = []
        for p in (self._embed, self._norm, self._head):
            if id(p) not in seen:
                self._outer.append(p)
                seen.add(id(p))
        self._params = [p for p in mine + self._outer if p.requires_grad]
        self._state = optimizer.init_state(self._params)
        self._bank = LinearBank([self._layers[v * self._K + k]
                                 for v in self._virtual()
                                 for k in range(self._K)]) \
            if self._split else None
        # the other stages' layers and their parameters' shapes
        self._foreign: List[Tuple[torch.Tensor, torch.Size]] = []
        if not _in_process(mesh) and S > 1:
            own = {id(p) for p in mine}
            self._foreign = [(p, p.shape) for layer in self._layers
                             for p in layer.parameters() if id(p) not in own]
        self._release()
        self._ticks = tick_table(stage_orders(self._kind, S, self._M, R),
                                 S, R)
        self._step = 0
        if not _in_process(mesh) and mesh.axis_size(axis) > 1:
            # the group's first operation is a collective every rank joins,
            # before any point-to-point
            C.all_reduce(torch.zeros(1, device=self._embed.device),
                         group=axis)

    def _release(self) -> None:
        """Empty the other stages' layers' parameters in place (the tensor
        objects stay the model's; their storage goes)."""
        for p, _ in self._foreign:
            if p.numel():
                p.data = p.data.new_empty(0)

    def _virtual(self) -> List[int]:
        S, R = self._S, self._R
        return [p * S + s for s in self._stages for p in range(R)]

    def _layer_params(self, v: int) -> List[torch.Tensor]:
        out = []
        for k in range(self._K):
            out += list(self._layers[v * self._K + k].parameters())
        return out

    def _stage_params(self, v: int) -> List[torch.Tensor]:
        """Virtual stage v's layers' parameters, with the embedding at v =
        0 and the final norm and head at the last (a tied head is the
        embedding, listed once)."""
        ps = self._layer_params(v)
        extra = [self._embed] if v == 0 else []
        if v == self._S * self._R - 1:
            extra += [self._norm, self._head]
        for p in extra:
            if all(p is not q for q in ps):
                ps.append(p)
        return [p for p in ps if p.requires_grad]

    def _local_rows(self, t):
        """``[M, rows of this rank, ...]``: consecutive micro-batches, each
        split over the batch axes."""
        B = t.shape[0]
        M = self._M
        if B % M:
            raise ValueError(f"batch {B} not divisible by num_microbatches "
                             f"{M}")
        mb = B // M
        t = t.reshape((M, mb) + tuple(t.shape[1:]))
        axes = tuple(a for a in self._batch_axes
                     if self._mesh.axis_size(a) > 1)
        if not axes:
            return t
        n = self._mesh.group_size(axes)
        if mb % n:
            raise ValueError(f"micro-batch size {mb} (= batch {B} / "
                             f"microbatches {M}) must divide over data axes "
                             f"{axes} (total {n})")
        r = self._mesh.group_rank(axes)
        return t[:, r * (mb // n):(r + 1) * (mb // n)]

    def __call__(self, input_ids, labels):
        model, S, R = self._model, self._S, self._R
        V = S * R
        self._step += 1
        self._release()
        ids, lab = self._local_rows(input_ids), self._local_rows(labels)
        seq = input_ids.shape[1]
        core = model.model
        cos, sin = core.rope_cos[:seq], core.rope_sin[:seq]
        # each micro-batch's loss is its share of the mean over every token
        counts = (lab[:, :, 1:] != -100).sum((1, 2)).float()
        total = (labels[:, 1:] != -100).sum().float().clamp_min(1)
        share = counts / total
        losses = []

        def layer_call(layer, x):
            if self._remat:
                return checkpoint(layer, x, cos, sin, use_reentrant=False)
            return layer(x, cos, sin)

        def forward(m, v, x):
            if v == 0:
                x = core.embed_tokens(ids[m])
            for k in range(self._K):
                x = layer_call(self._layers[v * self._K + k], x)
            if v == V - 1:
                return model.lm_loss(x, lab[m])[0] * share[m]
            return x

        if _in_process(self._mesh) or S == 1:
            exchange = local_exchange
        else:
            exchange = P2PExchange(
                self._mesh.group_ranks(self._axis), self._stages[0], R,
                (ids.shape[1], seq, model.config.hidden_size),
                self._embed.dtype, self._embed.device, self._axis)
        runner = Runner(S, R, self._stages, exchange, forward,
                        self._stage_params,
                        on_output=lambda m, y: losses.append(y.detach()),
                        split=self._split, bank=self._bank)
        if self._bank is None:
            runner.run(self._ticks)
        else:
            with self._bank:
                runner.run(self._ticks)
        grads = []
        with torch.no_grad():
            for p in self._params:
                g = runner.grad_of(p)
                grads.append(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device) if g is None
                             else g)
            multi = not _in_process(self._mesh)
            if multi and S > 1:
                outer = {id(p) for p in self._outer}
                for p, g in zip(self._params, grads):
                    if id(p) in outer:
                        C.all_reduce(g, group=self._axis)
            axes = tuple(a for a in self._batch_axes
                         if self._mesh.axis_size(a) > 1) if multi else ()
            if axes:
                for g in grads:
                    C.all_reduce(g, group=axes)
            grads = [g.to(p.dtype) for g, p in zip(grads, self._params)]
            self._opt.apply_gradients_(self._params, grads, self._state,
                                       self._opt.get_lr(), self._step)
            loss = torch.stack(losses).sum() if losses else \
                torch.zeros((), dtype=torch.float32, device=self._embed.device)
            if multi:
                if axes:
                    C.all_reduce(loss, group=axes)
                if S > 1:
                    C.all_reduce(loss, group=self._axis)
        return loss

    @property
    def params(self):
        """This rank's parameters as JAX lays them out: ``{"blocks": {name:
        [R, S_here, K, ...]}, "outer": {name: tensor}}`` (S_here the stages
        this process holds; the blocks are stacked copies)."""
        names = dict((id(p), n) for n, p in self._model.named_parameters())
        per = []
        for p in range(self._R):
            for s in self._stages:
                for k in range(self._K):
                    layer = self._layers[(p * self._S + s) * self._K + k]
                    per.append({n: t.detach()
                                for n, t in layer.named_parameters()})
        blocks = stack_layer_params(per, self._R, len(self._stages))
        return {"blocks": blocks,
                "outer": {names[id(p)]: p.detach() for p in self._outer}}

    def gather_params_to_model(self) -> None:
        """Every layer's trained parameters into every rank's model: each
        broadcast over the pp group from the rank of its stage into fresh
        storage where this rank had released it (the replicated parameters
        are equal already). In one process the model holds them already.
        The next call releases the other stages' layers again."""
        if _in_process(self._mesh) or self._S == 1:
            return
        ranks = self._mesh.group_ranks(self._axis)
        for p, shape in self._foreign:
            if p.shape != shape:
                p.data = p.data.new_empty(shape)
        with torch.no_grad():
            for i, layer in enumerate(self._layers):
                src = ranks[(i // self._K) % self._S]
                for p in layer.parameters():
                    C.broadcast(p.data, src=src, group=self._axis)
