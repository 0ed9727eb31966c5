"""Sharded training: ZeRO stages and tensor / sequence / data parallelism
over a :class:`~.topology.HybridMesh` (the counterpart of
``paddle_tpu/parallel/sharding.py``), with explicit collectives.

The JAX step gives every parameter, gradient and optimizer state a
sharding and lets GSPMD place the collectives; here each rank holds plain
local tensors and the step places them:

* tensor parallel: the name rules (:func:`llama_sharding_rules`, written in
  the JAX ``[in, out]`` layout; a ``torch.nn.Linear`` weight is its
  transpose) cut column-parallel weights on their output dim (the input
  through ``c_identity``), row-parallel ones on their input dim (the
  output all-reduced, a bias added after) and the embedding on its vocab
  rows (a masked lookup and an all-reduce); the LM head's vocab shard feeds
  a vocab-parallel cross entropy. Attention views q, k and v with the head
  count of its shard.
* ZeRO over ``fsdp`` (``:37-44`` of the JAX module): stage 1 keeps each
  rank's optimizer state for its slice of every parameter (the ``fsdp``
  dim of the stage-3 spec); stage 2 adds the gradients, reduce-scattered
  onto those slices; stage 3 adds the parameters: each rank stores its
  slice, and every unit (a decoder layer, the embedding, the final norm,
  the head) gathers its parameters before its forward and again before its
  backward (the unit's forward is recomputed) and frees them after. Stages
  1 and 2 all-gather the updated slices.
* data parallel over ``dp`` and ``fsdp`` (the batch's dim 0) and the
  sequence over ``sep`` (dim 1; labels shifted before the split, rope rows
  at global positions, attention by ``sep_attention`` inside
  ``sequence_sharded``): the loss is the sum over this rank's tokens
  divided by the count over every rank, so the summed gradients are those
  of the global mean, as in JAX.

At tp = sep = 1 a causal LM computes its loss by its own labelled forward
(the stage-3 head gathered around ``lm_loss``); under tp or sep the step
runs the decoder and puts the head and the loss on the shards itself (a
vocab-parallel cross entropy under tp).

The global-norm clip spans every shard (``ClipGradByGlobalNorm`` with each
gradient's sharded axes). The update runs on each rank's local tensors
through the optimizer's ``apply_gradients_``, as JAX's
``apply_gradients_tree`` does. Tensor and sequence parallelism need the
port's causal LMs (a ``.model`` with ``embed_tokens`` / ``norm``, a
``head_weight`` and ``lm_loss``); a generic model with ``loss_fn`` trains
data parallel with ZeRO. The column, row and vocab forms are
``mp_layers``' functional ones.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..nn.clip import ClipGradByGlobalNorm
from . import collective as C
from .mp_layers import (column_parallel_linear, row_parallel_linear,
                        vocab_parallel_cross_entropy,
                        vocab_parallel_embedding)
from .sequence_parallel import sequence_sharded

__all__ = ["ShardingStage", "ShardedTrainStep", "llama_sharding_rules",
           "spec_for", "P"]

IGNORE_INDEX = -100


class _Unconstrained:
    def __repr__(self):
        return "P.UNCONSTRAINED"


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): one entry a
    dim, None (replicated), a mesh axis name or a tuple of names, or
    ``P.UNCONSTRAINED`` (left as it is; ``activation_sharding``)."""

    UNCONSTRAINED = _Unconstrained()

    def __new__(cls, *parts):
        return tuple.__new__(cls, parts)

    def __reduce__(self):
        return type(self), tuple(self)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class ShardingStage:
    """ZeRO stage (``group_sharded_parallel`` levels: os = 1, os_g = 2,
    p_g_os = 3)."""

    NONE = 0
    OS = 1
    OS_G = 2
    P_G_OS = 3


def llama_sharding_rules():
    """Megatron-style tp rules with the fsdp dim for the Llama family, in
    the JAX ``[in, out]`` layout: (name regex, spec)."""
    return [
        (r".*embed_tokens\.weight$", P(("tp", "fsdp"), None)),
        (r".*(q_proj|k_proj|v_proj|gate_proj|up_proj)\.weight$",
         P("fsdp", "tp")),
        (r".*(o_proj|down_proj)\.weight$", P("tp", "fsdp")),
        (r".*lm_head\.weight$", P("fsdp", "tp")),
        (r".*(layernorm|norm)\.weight$", P()),
        (r".*bias$", P()),
    ]


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_for(name: str, shape, rules, stage: int, mesh,
             override: Optional[P] = None) -> P:
    """The spec of a parameter from the rules (or ``override``) and the
    ZeRO stage, as JAX resolves it: below stage 3 fsdp is stripped; at
    stage 3 a spec without fsdp gains it on its first free dim, and a
    parameter no rule names shards its largest dim; an axis that does not
    divide its dim is dropped (the longest dividing prefix of a tuple
    kept)."""
    sizes = mesh.sizes if hasattr(mesh, "sizes") else dict(mesh)
    spec = override
    if spec is None:
        for pat, s in rules:
            if re.match(pat, name):
                spec = s
                break
    elif stage >= ShardingStage.P_G_OS and len(shape) >= 1:
        flat = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        used = set()
        for e in flat:
            used.update(_names(e))
        if "fsdp" not in used:
            for d, e in enumerate(flat):
                if e is None:
                    spec = P(*(flat[:d] + ("fsdp",) + flat[d + 1:]))
                    break
    if spec is None:
        spec = P()
        if stage >= ShardingStage.P_G_OS and len(shape) >= 1:
            big = int(max(range(len(shape)), key=lambda i: shape[i]))
            parts = [None] * len(shape)
            parts[big] = "fsdp"
            spec = P(*parts)
    if stage < ShardingStage.P_G_OS:
        parts = []
        for entry in spec:
            kept = tuple(a for a in _names(entry) if a != "fsdp")
            parts.append(None if not kept else
                         (kept[0] if len(kept) == 1 else kept))
        spec = P(*parts)
    out = []
    for dim, entry in enumerate(tuple(spec)
                                + (None,) * (len(shape) - len(tuple(spec)))):
        kept, tot = [], 1
        for a in _names(entry):
            if shape[dim] % (tot * sizes[a]) == 0:
                kept.append(a)
                tot *= sizes[a]
        out.append(None if not kept else
                   (kept[0] if len(kept) == 1 else tuple(kept)))
    return P(*out)


def _dim_of(spec, axis: str, linear: bool) -> Optional[int]:
    """The torch dim that ``axis`` shards in a JAX-layout ``spec``."""
    for d, entry in enumerate(spec):
        if axis in _names(entry):
            return 1 - d if linear else d
    return None


class _Shard:
    """One parameter's placement: its tp dim and fsdp dims (torch
    layout), and where the step keeps its optimizer state."""

    def __init__(self, name, param, module, pname, spec, state_spec,
                 linear, mesh):
        self.name, self.param, self.module, self.pname = \
            name, param, module, pname
        self.linear = linear
        self.tp_dim = _dim_of(spec, "tp", linear) \
            if mesh.axis_size("tp") > 1 else None
        fs = mesh.axis_size("fsdp") > 1
        self.fsdp_dim = _dim_of(spec, "fsdp", linear) if fs else None
        self.state_dim = _dim_of(state_spec, "fsdp", linear) if fs else None


def _chunk(t, n, i, dim):
    return t if dim is None or n == 1 else \
        t.chunk(n, dim=dim)[i].contiguous()


class _GatherParam(torch.autograd.Function):
    """A stage-3 parameter slice all-gathered over fsdp; the gradient
    reduce-scattered back onto the slice."""

    @staticmethod
    def forward(ctx, shard, dim):
        ctx.dim = dim
        return C.all_gather(shard.contiguous(), group="fsdp", axis=dim)

    @staticmethod
    def backward(ctx, g):
        return C.reduce_scatter(g.contiguous(), group="fsdp",
                                axis=ctx.dim), None


class ShardedTrainStep:
    """``step = ShardedTrainStep(model, loss_fn, optimizer, mesh, stage,
    rules, batch_spec, clip_norm)``; ``loss = step(*batch)`` with the
    GLOBAL batch on every rank (each takes its part), returns the global
    loss. The step owns the model's parameters: while it holds them they
    are this rank's shards; :meth:`gather_params_to_model` puts the full
    tensors back (the next call shards them again). ``batch_spec`` is the
    mesh axes of the batch's dim 0 (default the data axes dp and fsdp);
    ``remat`` recomputes every unit in the backward."""

    def __init__(self, model: nn.Module, loss_fn, optimizer, mesh,
                 stage: int = ShardingStage.P_G_OS,
                 rules: Optional[list] = None, batch_spec=None,
                 clip_norm: Optional[float] = None, training: bool = True,
                 remat: bool = False):
        self._model, self._loss_fn, self._opt = model, loss_fn, optimizer
        self._mesh, self._stage = mesh, int(stage)
        self._clip_norm = clip_norm
        self._rules = rules if rules is not None else llama_sharding_rules()
        self._data_axes = tuple(batch_spec) if batch_spec is not None \
            else ("dp", "fsdp")
        self._remat = remat
        model.train(training)
        sizes = mesh.sizes
        self._tp, self._sep = sizes["tp"], sizes["sep"]
        self._lm = loss_fn is None and hasattr(model, "head_weight") \
            and hasattr(model, "model")
        if (self._tp > 1 or self._sep > 1) and not self._lm:
            raise ValueError("ShardedTrainStep: tp and sep need one of the "
                             "port's causal LMs (loss_fn=None)")
        cfg = getattr(model, "config", None)
        if self._tp > 1 and cfg is not None and (
                cfg.num_attention_heads % self._tp
                or cfg.num_key_value_heads % self._tp):
            raise ValueError(f"ShardedTrainStep: tp {self._tp} must divide "
                             f"the heads ({cfg.num_attention_heads} / "
                             f"{cfg.num_key_value_heads})")
        if self._sep > 1 and cfg is not None \
                and not getattr(cfg, "context_parallel", False):
            raise ValueError("ShardedTrainStep: sep > 1 needs a model with "
                             "context_parallel=True")
        owners = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                owners.setdefault(id(p), (mod, pname))
        self._shards: List[_Shard] = []
        for name, p in model.named_parameters():
            if not p.requires_grad:
                continue
            mod, pname = owners[id(p)]
            linear = isinstance(mod, nn.Linear) and pname == "weight"
            jshape = tuple(p.shape)[::-1] if linear else tuple(p.shape)
            override = getattr(p, "_dist_spec", None)
            spec = spec_for(name, jshape, self._rules, self._stage, mesh,
                            override)
            sspec = spec_for(name, jshape, self._rules,
                             ShardingStage.P_G_OS, mesh, override) \
                if self._stage >= ShardingStage.OS else spec
            self._shards.append(_Shard(name, p, mod, pname, spec, sspec,
                                       linear, mesh))
        # a column-parallel linear's bias is cut with its output dim
        by_param = {id(s.param): s for s in self._shards}
        for s in self._shards:
            bias = getattr(s.module, "bias", None)
            if s.linear and s.tp_dim == 0 and id(bias) in by_param:
                by_param[id(bias)].tp_dim = 0
        self._fsdp_rank = mesh.axis_rank("fsdp")
        self._tp_rank = mesh.axis_rank("tp")
        self._sharded = False
        self._overrides: Dict[Tuple[nn.Module, str], object] = {}
        self._shard_model()
        self._state = self._init_opt_state([self._update_view(s)
                                            for s in self._shards])
        self._step = 0

    def _init_opt_state(self, views):
        """The optimizer state of each updated view (``offload`` keeps it
        on the host)."""
        return self._opt.init_state(views)

    def _grads_enqueued(self) -> None:
        """Called once the backward has been enqueued (``offload`` starts
        its first state copy there)."""

    def _apply_update(self, views, grads) -> None:
        """The optimizer's in-place update of this rank's views."""
        self._opt.apply_gradients_(views, grads, self._state,
                                   self._opt.get_lr(), self._step)

    # -- placing the model ---------------------------------------------------
    def _local(self, s: _Shard, full):
        t = _chunk(full, self._tp, self._tp_rank, s.tp_dim)
        if self._stage >= ShardingStage.P_G_OS:
            t = _chunk(t, self._mesh.axis_size("fsdp"), self._fsdp_rank,
                       s.fsdp_dim)
        return t

    def _update_view(self, s: _Shard):
        """What this rank's optimizer updates: the stored tensor at stage
        3 (or without an fsdp state dim), else its fsdp slice."""
        p = s.param
        if self._stage >= ShardingStage.P_G_OS or s.state_dim is None:
            return p
        n = self._mesh.axis_size("fsdp")
        c = p.shape[s.state_dim] // n
        return p.narrow(s.state_dim, self._fsdp_rank * c, c)

    def _override(self, mod, fn, attr="forward"):
        self._overrides.setdefault((mod, attr), mod.__dict__.get(attr))
        setattr(mod, attr, fn)

    def _shard_model(self):
        if self._sharded:
            return
        with torch.no_grad():
            for s in self._shards:
                s.param.data = self._local(s, s.param.data)
        self._install_tp()
        if self._remat or (self._stage >= ShardingStage.P_G_OS
                           and self._mesh.axis_size("fsdp") > 1):
            self._install_units()
        if self._lm and self._head().fsdp_dim is not None \
                and self._stage >= ShardingStage.P_G_OS:
            self._install_head()
        self._sharded = True

    def _install_tp(self):
        if self._tp == 1:
            return
        by_mod = {}
        for s in self._shards:
            by_mod.setdefault(s.module, {})[s.pname] = s
        for mod, ps in by_mod.items():
            w = ps.get("weight")
            if w is None or w.tp_dim is None:
                continue
            if isinstance(mod, nn.Embedding) and w.tp_dim == 0:
                self._override(mod, lambda ids, m=mod:
                               vocab_parallel_embedding(
                                   ids, m.weight, "tp", self._tp,
                                   self._tp_rank))
            elif isinstance(mod, nn.Linear) and w.tp_dim in (0, 1):
                fn = column_parallel_linear if w.tp_dim == 0 \
                    else row_parallel_linear
                self._override(mod, lambda x, m=mod, fn=fn: fn(
                    x, m.weight.t(), m.bias, "tp", self._tp))
            else:
                raise ValueError(f"ShardedTrainStep: no tensor-parallel form "
                                 f"for {w.name} on a {type(mod).__name__}")

    def _head(self) -> _Shard:
        return next(s for s in self._shards
                    if s.param is self._model.head_weight)

    def _install_head(self):
        """Stage 3: the model's ``lm_loss`` gathers the head's fsdp slices
        before its forward and again before its backward."""
        head, inner = self._head(), self._model.lm_loss

        def lm_loss(h, labels):
            return checkpoint(lambda x: inner(
                x, labels, self._gathered([head])[head]), h,
                use_reentrant=False)
        self._override(self._model, lm_loss, "lm_loss")

    def _units(self):
        """Decoder layers (the entries of every ModuleList) and every other
        module that holds parameters itself."""
        units, inside = [], set()
        for mod in self._model.modules():
            if isinstance(mod, nn.ModuleList):
                for u in mod:
                    units.append(u)
                    inside.update(id(m) for m in u.modules())
        for mod in self._model.modules():
            if id(mod) not in inside and not isinstance(mod, nn.ModuleList) \
                    and any(True for _ in mod.parameters(recurse=False)):
                units.append(mod)
                inside.add(id(mod))
        return units

    def _gathered(self, shards: List[_Shard]):
        """``{name: gathered tensor}`` relative to nothing: the stage-3
        slices all-gathered over fsdp (the others as stored)."""
        out = {}
        for s in shards:
            if self._stage >= ShardingStage.P_G_OS and s.fsdp_dim is not None:
                out[s] = _GatherParam.apply(s.param, s.fsdp_dim)
            else:
                out[s] = s.param
        return out

    def _install_units(self):
        by_param = {id(s.param): s for s in self._shards}
        for unit in self._units():
            rel = {n: by_param[id(p)] for n, p in unit.named_parameters()
                   if id(p) in by_param}
            inner = unit.forward

            def wrapper(*a, _u=unit, _rel=rel, _inner=inner, **k):
                if getattr(_u, "_ptt_in_unit", False):
                    return _inner(*a, **k)

                def run(*args):
                    full = self._gathered(list(_rel.values()))
                    _u._ptt_in_unit = True
                    try:
                        return functional_call(
                            _u, {n: full[s] for n, s in _rel.items()}, args,
                            k)
                    finally:
                        _u._ptt_in_unit = False
                return checkpoint(run, *a, use_reentrant=False)
            self._override(unit, wrapper)

    def _unshard_model(self):
        if not self._sharded:
            return
        for (mod, attr), fn in self._overrides.items():
            delattr(mod, attr)
            if fn is not None:
                setattr(mod, attr, fn)
        self._overrides = {}
        with torch.no_grad():
            for s in self._shards:
                t = s.param.data
                if self._stage >= ShardingStage.P_G_OS \
                        and s.fsdp_dim is not None:
                    t = C.all_gather(t.contiguous(), group="fsdp",
                                     axis=s.fsdp_dim)
                if s.tp_dim is not None:
                    t = C.all_gather(t.contiguous(), group="tp",
                                     axis=s.tp_dim)
                s.param.data = t
        self._sharded = False

    # -- the batch and the loss ----------------------------------------------
    def _axes(self, names):
        return tuple(a for a in names if self._mesh.axis_size(a) > 1)

    def _local_batch(self, t):
        axes = self._axes(self._data_axes)
        if axes and torch.is_tensor(t) and t.dim() >= 1:
            n = self._mesh.group_size(axes)
            t = t.chunk(n, dim=0)[self._mesh.group_rank(axes)]
        return t

    def _lm_loss(self, ids, labels):
        """``(the mean of this rank's token losses, its token count)``."""
        if self._tp == 1 and self._sep == 1:
            ids, labels = self._local_batch(ids), self._local_batch(labels)
            return self._model(ids, labels)[0], \
                (labels[:, 1:] != IGNORE_INDEX).sum()
        core = self._model.model
        # position t predicts label t + 1: shift before any split
        labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1],
                                                           IGNORE_INDEX)], 1)
        ids, labels = self._local_batch(ids), self._local_batch(labels)
        pos = None
        if self._sep > 1:
            n, r = self._sep, self._mesh.axis_rank("sep")
            s = ids.shape[1] // n
            ids = ids[:, r * s:(r + 1) * s]
            labels = labels[:, r * s:(r + 1) * s]
            pos = (torch.arange(s, device=ids.device) + r * s)[None] \
                .expand(ids.shape[0], s)
        h = core.norm(core(ids, position_ids=pos))
        head = self._head()

        def head_loss(h, w):
            logits = column_parallel_linear(h, w.t(), None, "tp", self._tp)
            return vocab_parallel_cross_entropy(logits, labels, "tp",
                                                IGNORE_INDEX).sum()
        if self._stage >= ShardingStage.P_G_OS and head.fsdp_dim is not None:
            total = checkpoint(lambda x: head_loss(
                x, self._gathered([head])[head]), h, use_reentrant=False)
        else:
            total = head_loss(h, head.param)
        count = (labels != IGNORE_INDEX).sum()
        return total / count.clamp_min(1), count

    def _loss(self, batch):
        """``(the loss to differentiate, the global loss)``."""
        axes = self._axes(self._data_axes + ("sep",))
        if self._lm:
            ids = batch[0]
            labels = batch[1] if len(batch) > 1 else ids
            mean, count = self._lm_loss(ids, labels)
            count = count.float()
            every = C.all_reduce(count.clone(), group=axes) if axes \
                else count
            # this rank's share of the global mean (exactly the mean alone)
            loss = mean * (count / every.clamp_min(1))
        else:
            local = tuple(self._local_batch(t) for t in batch)
            out = self._model(*local)
            if self._loss_fn is None:
                loss = out[0] if isinstance(out, (tuple, list)) else out
            else:
                loss = self._loss_fn(out, *local)
            n = self._mesh.group_size(axes) if axes else 1
            loss = loss / n
        shown = C.all_reduce(loss.detach().clone(), group=axes) \
            if axes else loss.detach()
        return loss, shown

    # -- the step ------------------------------------------------------------
    def _sync_grads(self, grads):
        """Sum over the data and sequence axes; at stage 2 the sum over
        fsdp lands reduce-scattered on each rank's state slice."""
        stage3 = self._stage >= ShardingStage.P_G_OS
        fs = self._mesh.axis_size("fsdp") > 1
        out = []
        for s, g in zip(self._shards, grads):
            rest = ("dp", "sep")
            if not fs:
                rest = rest + ("fsdp",)
            elif stage3 and s.fsdp_dim is not None:
                pass            # reduce-scattered by the gather's backward
            elif self._stage == ShardingStage.OS_G \
                    and s.state_dim is not None:
                g = C.reduce_scatter(g, group="fsdp", axis=s.state_dim)
            else:
                rest = rest + ("fsdp",)
            axes = self._axes(rest)
            if axes:
                g = C.all_reduce(g.contiguous(), group=axes)
            if self._stage == ShardingStage.OS and fs \
                    and s.state_dim is not None:
                n = self._mesh.axis_size("fsdp")
                c = g.shape[s.state_dim] // n
                g = g.narrow(s.state_dim, self._fsdp_rank * c, c)
            out.append(g)
        return out

    def _grad_axes(self, s: _Shard):
        axes = ("tp",) if s.tp_dim is not None else ()
        sharded = (s.fsdp_dim if self._stage >= ShardingStage.P_G_OS
                   else s.state_dim if self._stage >= ShardingStage.OS_G
                   else None)
        if sharded is not None:
            axes = axes + ("fsdp",)
        if self._stage == ShardingStage.OS and s.state_dim is not None \
                and self._mesh.axis_size("fsdp") > 1:
            axes = axes + ("fsdp",)
        return axes

    def __call__(self, *batch) -> torch.Tensor:
        self._shard_model()
        self._step += 1
        params = [s.param for s in self._shards]
        with sequence_sharded() if self._sep > 1 \
                else contextlib.nullcontext():
            loss, shown = self._loss(batch)
            grads = list(torch.autograd.grad(loss, params,
                                             allow_unused=True,
                                             materialize_grads=True))
        self._grads_enqueued()
        with torch.no_grad():
            grads = self._sync_grads(grads)
            if self._clip_norm is not None:
                holders = [_GradAxes(self._grad_axes(s))
                           for s in self._shards]
                clip = ClipGradByGlobalNorm(self._clip_norm)
                grads = [g for _, g in clip._clip(list(zip(holders, grads)))]
            views = [self._update_view(s) for s in self._shards]
            self._apply_update(views, grads)
            if self._stage < ShardingStage.P_G_OS \
                    and self._mesh.axis_size("fsdp") > 1:
                for s, v in zip(self._shards, views):
                    if s.state_dim is not None:
                        s.param.copy_(C.all_gather(v.contiguous(),
                                                   group="fsdp",
                                                   axis=s.state_dim))
        return shown

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """This rank's stored tensor of each parameter, by name."""
        return {s.name: s.param.detach() for s in self._shards}

    def sharded_state_dict(self):
        """``{name: LocalShard}`` of this rank's stored parameters (their
        global shapes and offsets), for ``parallel.save_state_dict`` and
        ``load_state_dict``, which read and fill them in place."""
        from .checkpoint import LocalShard

        self._shard_model()
        mesh, out = self._mesh, {}
        stage3 = self._stage >= ShardingStage.P_G_OS
        for s in self._shards:
            t = s.param.data
            full = list(t.shape)
            offs = [0] * t.dim()
            replicated = ["dp", "sep", "ep", "pp"]
            fdim = s.fsdp_dim if stage3 else None
            if fdim is not None:
                full[fdim] *= mesh.axis_size("fsdp")
                offs[fdim] = self._fsdp_rank * t.shape[fdim]
            else:
                replicated.append("fsdp")
            if s.tp_dim is not None:
                part = full[s.tp_dim]
                full[s.tp_dim] *= self._tp
                offs[s.tp_dim] += self._tp_rank * part
            else:
                replicated.append("tp")
            owner = all(mesh.axis_rank(a) == 0 for a in replicated)
            out[s.name] = LocalShard(t, full, offs, owner)
        return out

    def gather_params_to_model(self) -> None:
        """All-gather every shard back into the model's parameters and
        restore its modules (the stage-3 save path)."""
        self._unshard_model()


class _GradAxes:
    """A stand-in parameter for the clip: the axes its gradient is
    sharded over."""

    def __init__(self, axes):
        self._dist_axes = axes
