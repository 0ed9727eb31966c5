"""Mixture-of-experts: gates, stacked experts and the MoE layer (the
counterpart of ``paddle_tpu/parallel/moe.py:47-419`` on one device).

Routing is ``_route_sparse`` (:75-115) op for op: f32 logits and softmax,
top-k, the load-balancing aux loss over the primary choice, capacity slots
from a cumulative one-hot with every k = 0 choice ahead of every k = 1 choice
(choice rank has priority, token order within a rank), dropped gates zeroed
and the surviving top-k weights renormalised (floor 1e-9), slot ``C`` for a
dropped pair.

``MoELayer`` runs either of the JAX layer's two dispatches:

- ``"grouped"`` (``moe_grouped_fn``, :352-383): sort-free permutation of
  the routed rows into contiguous expert groups (a kept pair goes to its
  expert's base offset plus its capacity slot, dropped pairs after all kept
  rows in drop order), the grouped-GEMM experts (``apply_sorted``), the
  inverse gather, the gate weights and the sum over the k choices. The
  group sizes stay on the device: nothing here waits for the host.
- ``"capacity"`` (``moe_fn``, :385-412): tokens gathered into an
  ``[E, C, d]`` grid, batched expert products (``apply_raw``), combined back.

``"auto"`` takes the grouped route when every expert width is one the
kernels take (JAX's tileable rule, :334-340, and a multiple of 8), decided
from shapes on both devices: on the CPU the grouped route runs the kernels'
plain versions. A list of expert modules (``_StackedLayers``, :259-282) has
no grouped products and always takes the capacity route, as JAX's
``_use_grouped`` decides for experts without ``apply_sorted``.

Under ``auto_cast`` the routing, the dispatch and the experts are one op,
``moe_layer``, as in JAX (one ``dispatch_fn``, :414): its inputs (x, the
gate's weight and the experts' parameters) are cast by that name and
nothing inside is, except the modules of a list of experts, whose ops JAX
dispatches nested in ``moe_layer`` (``amp.nested_ops``). The expert-parallel
all-to-alls (``global_scatter``, ``global_gather``) and the ``ep`` sharding
rules wait for the port of ``parallel/`` (ROADMAP A8).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import amp_op, nested_ops
from ..core.device import make_generator, resolve_device
from ..core.dtype import to_torch_dtype
from ..ops.fused.grouped_gemm import grouped_matmul, grouped_matmul_swiglu

__all__ = ["NaiveGate", "SwitchGate", "GShardGate", "MLPExperts",
           "MoELayer"]


def _xavier_uniform_(p: torch.Tensor, fan_in: int, fan_out: int,
                     gen: torch.Generator) -> None:
    """``U(-a, a)`` with ``a = sqrt(6 / (fan_in + fan_out))``, as the JAX
    package's ``XavierUniform``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        p.uniform_(-limit, limit, generator=gen)


def _module_setup(device, dtype):
    dev = resolve_device(device)
    return dev, to_torch_dtype(dtype or "float32")


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
class _BaseGate(nn.Module):
    """Router: scores tokens against experts, picks the top k within a fixed
    per-expert capacity and carries the load-balancing aux loss. ``weight``
    is ``[d_model, num_experts]``, as in JAX, Xavier-uniform from a
    generator seeded with ``seed`` on ``device`` (default ``cuda``)."""

    def __init__(self, d_model: int, num_experts: int, topk: int,
                 capacity_factor: Optional[float], device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        dev, dt = _module_setup(device, dtype)
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.weight = nn.Parameter(torch.empty(d_model, num_experts,
                                               device=dev, dtype=dt))
        self.reset_parameters(make_generator(seed, dev))
        self._aux = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        _xavier_uniform_(self.weight, self.weight.shape[0],
                         self.weight.shape[1], gen)

    def capacity(self, num_tokens: int) -> int:
        if self.capacity_factor is None:
            return num_tokens  # no dropping
        c = int(math.ceil(self.topk * num_tokens / self.num_experts
                          * self.capacity_factor))
        return max(c, 1)

    def get_loss(self):
        """Aux loss of the latest forward."""
        return self._aux

    def _route_sparse(self, x: torch.Tensor, gate_w: torch.Tensor = None):
        """``x [N, d]`` -> ``(expert_idx [K*N] int32, slot [K*N] int32 (C =
        dropped), gate_p [K*N] f32, aux)``. Rows are ordered all k = 0
        choices first, token order within a rank."""
        gate_w = self.weight if gate_w is None else gate_w
        E, K = self.num_experts, self.topk
        N = x.shape[0]
        C = self.capacity(N)
        logits = x.float() @ gate_w.float()
        probs = torch.softmax(logits, dim=-1)                   # [N, E]
        topk_idx = torch.topk(probs, K, dim=-1).indices         # [N, K]
        onehot = F.one_hot(topk_idx, E)                         # [N, K, E]

        # aux load-balancing loss over the primary assignment
        me = probs.mean(dim=0)
        ce = onehot[:, 0, :].float().mean(dim=0)
        aux = torch.sum(me * ce) * E

        # capacity slots: queue position of each (choice rank, token) in
        # its expert, exact in integers. The queue runs along the last axis
        # of [E, K*N]: a scan down the first axis of [K*N, E] runs only E
        # scans side by side (5.6 ms per layer at K*N = 32768 on an H100).
        flat = onehot.permute(2, 1, 0).reshape(E, K * N)
        pos = torch.cumsum(flat, dim=1) - flat
        slot = torch.sum(pos * flat, dim=0)
        kept = torch.sum(flat * (pos < C), dim=0)               # 0 or 1

        gate_p = probs.gather(1, topk_idx).t().reshape(K * N) * kept
        if K > 1:
            per_tok = gate_p.reshape(K, N)
            denom = torch.clamp_min(per_tok.sum(dim=0, keepdim=True), 1e-9)
            gate_p = (per_tok / denom).reshape(K * N)
        expert_idx = topk_idx.t().reshape(K * N).to(torch.int32)
        slot_i = torch.where(kept > 0, slot, C).to(torch.int32)
        return expert_idx, slot_i, gate_p, aux


class NaiveGate(_BaseGate):
    """Top-k routing, no capacity limit, no aux loss."""

    def __init__(self, d_model, num_experts, topk: int = 2, **kw):
        super().__init__(d_model, num_experts, topk, None, **kw)

    def _route_sparse(self, x, gate_w=None):
        expert_idx, slot_i, gate_p, _ = super()._route_sparse(x, gate_w)
        return expert_idx, slot_i, gate_p, torch.zeros(
            (), dtype=torch.float32, device=x.device)


class SwitchGate(_BaseGate):
    """Top-1 routing with capacity."""

    def __init__(self, d_model, num_experts, capacity_factor: float = 1.25,
                 **kw):
        super().__init__(d_model, num_experts, 1, capacity_factor, **kw)


class GShardGate(_BaseGate):
    """Top-2 routing with capacity."""

    def __init__(self, d_model, num_experts, capacity_factor: float = 2.0,
                 **kw):
        super().__init__(d_model, num_experts, 2, capacity_factor, **kw)


# ---------------------------------------------------------------------------
# experts
# ---------------------------------------------------------------------------
class MLPExperts(nn.Module):
    """E experts as one stacked parameter set: ``w1 [E, d, h·mult]``,
    ``b1 [E, 1, h·mult]``, ``w2 [E, h, d]``, ``b2 [E, 1, d]`` (``mult`` 2
    for swiglu: gate columns, then up columns). Weights Xavier-uniform
    (``w1`` with fans ``(d, h)``, ``w2`` with ``(h, d)``), biases zero, as
    JAX initialises them. ``activation``: ``"gelu"`` (tanh approximation,
    as ``jax.nn.gelu``), ``"relu"`` or ``"swiglu"``."""

    def __init__(self, num_experts: int, d_model: int, d_hidden: int,
                 activation: str = "gelu", device=None, dtype=None,
                 seed: int = 0):
        super().__init__()
        if activation not in ("gelu", "relu", "swiglu"):
            raise ValueError(f"MLPExperts: unknown activation {activation!r}")
        dev, dt = _module_setup(device, dtype)
        self.num_experts = num_experts
        self.activation = activation
        mult = 2 if activation == "swiglu" else 1
        empty = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(*shape, device=dev, dtype=dt))
        self.w1 = empty(num_experts, d_model, d_hidden * mult)
        self.b1 = empty(num_experts, 1, d_hidden * mult)
        self.w2 = empty(num_experts, d_hidden, d_model)
        self.b2 = empty(num_experts, 1, d_model)
        self.reset_parameters(make_generator(seed, dev))

    def reset_parameters(self, gen: torch.Generator) -> None:
        d_model, d_hidden = self.w2.shape[2], self.w2.shape[1]
        _xavier_uniform_(self.w1, d_model, d_hidden, gen)
        _xavier_uniform_(self.w2, d_hidden, d_model, gen)
        with torch.no_grad():
            self.b1.zero_()
            self.b2.zero_()

    def _act(self, h):
        if self.activation == "swiglu":
            g, u = h.chunk(2, dim=-1)
            return F.silu(g) * u
        if self.activation == "relu":
            return F.relu(h)
        return F.gelu(h, approximate="tanh")

    def apply_raw(self, xe: torch.Tensor, params=None) -> torch.Tensor:
        """The capacity grid: ``xe [E, C, d]`` -> ``[E, C, d]`` by batched
        products. ``params``: ``{w1, b1, w2, b2}`` to use in place of the
        module's own (their cast copies under ``auto_cast``)."""
        p = dict(self.named_parameters()) if params is None else params
        h = self._act(torch.bmm(xe, p["w1"]) + p["b1"])
        return torch.bmm(h, p["w2"]) + p["b2"]

    def apply_sorted(self, xs: torch.Tensor, group_sizes: torch.Tensor,
                     params: dict) -> torch.Tensor:
        """Grouped-GEMM expert FFN on expert-sorted rows: ``xs [T, d]`` with
        the rows of expert e contiguous (``group_sizes [E]`` int32 kept-row
        counts; trailing rows are dropped pairs and come back zero, bias
        included). Swiglu runs the fused gate + up + swiglu product; other
        activations a product, the activation, and the second product.
        ``params``: ``{w1, b1, w2, b2}``, as :meth:`apply_raw` takes them."""
        w1, b1 = params["w1"], params["b1"][:, 0, :]
        if self.activation == "swiglu":
            h = grouped_matmul_swiglu(xs, w1, group_sizes, b1)
        else:
            h = self._act(grouped_matmul(xs, w1, group_sizes, b1)).to(
                xs.dtype)
        return grouped_matmul(h, params["w2"], group_sizes,
                              params["b2"][:, 0, :])

    def forward(self, xe):
        return self.apply_raw(xe)


class _StackedLayers(nn.Module):
    """A list of expert modules, expert ``e`` applied to slot ``e`` of the
    capacity grid (``paddle_tpu/parallel/moe.py:259-282``). Submodules are
    named ``"0"``, ``"1"``, ... as JAX names them."""

    def __init__(self, experts):
        super().__init__()
        for i, e in enumerate(experts):
            self.add_module(str(i), e)
        self.num_experts = len(experts)

    def apply_raw(self, xe: torch.Tensor, params: dict) -> torch.Tensor:
        """``xe [E, C, d]`` -> ``[E, C, d]``: ``self[e](xe[e])`` for each
        e, with ``params`` (``{"e.name": tensor}``) in place of the
        modules' own."""
        outs = []
        with nested_ops():
            for i in range(self.num_experts):
                mod = getattr(self, str(i))
                pre = f"{i}."
                sub = {k[len(pre):]: v for k, v in params.items()
                       if k.startswith(pre)}
                outs.append(torch.func.functional_call(mod, sub, (xe[i],)))
        return torch.stack(outs)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
def _kernel_width(d: int) -> bool:
    # JAX's tileable rule, and whole 16-byte bf16 rows for the kernels
    return (d <= 128 or d % 128 == 0) and d % 8 == 0


class MoELayer(nn.Module):
    """Mixture-of-experts layer: ``out = combine(experts(dispatch(x)))``.
    ``experts``: an ``MLPExperts`` or a list of expert modules (each maps
    ``[C, d]`` to ``[C, d]``). ``aux_loss`` (and ``gate.get_loss()``) holds
    the latest forward's load-balancing term; ``expert_load`` the kept rows
    per expert of the latest grouped forward (an int32 device tensor, None
    after a capacity forward). ``dispatch``: ``"auto"``, ``"grouped"`` or
    ``"capacity"``."""

    def __init__(self, gate: _BaseGate, experts, dispatch: str = "auto"):
        super().__init__()
        if dispatch not in ("auto", "grouped", "capacity"):
            raise ValueError(f"unknown MoE dispatch mode {dispatch!r}")
        if isinstance(experts, (list, tuple)):
            experts = _StackedLayers(experts)
        self.gate = gate
        self.experts = experts
        self.dispatch = dispatch
        self.aux_loss = None
        self.expert_load = None

    def use_grouped(self) -> bool:
        if not hasattr(self.experts, "apply_sorted"):
            return False
        if self.dispatch != "auto":
            return self.dispatch == "grouped"
        w1, w2 = self.experts.w1, self.experts.w2
        return all(_kernel_width(int(d)) for d in (
            w1.shape[1], w1.shape[2], w2.shape[1], w2.shape[2]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.route_and_combine(x, self.gate.weight,
                                      dict(self.experts.named_parameters()))

    @amp_op("moe_layer")
    def route_and_combine(self, x: torch.Tensor, gate_w: torch.Tensor,
                          eparams: dict) -> torch.Tensor:
        """The layer on x with the gate weight ``gate_w`` and the experts'
        parameters ``eparams`` (by name): JAX's ``moe_layer`` op."""
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        expert_idx, slot_i, gate_p, aux = self.gate._route_sparse(flat,
                                                                  gate_w)
        if self.use_grouped():
            out = self._grouped(flat, expert_idx, slot_i, gate_p, eparams)
        else:
            out = self._capacity(flat, expert_idx, slot_i, gate_p, eparams)
            self.expert_load = None
        self.gate._aux = aux
        self.aux_loss = aux
        return out.reshape(shape).to(x.dtype)

    def _grouped(self, flat, expert_idx, slot_i, gate_p, eparams):
        N, D = flat.shape
        E = self.gate.num_experts
        C = self.gate.capacity(N)
        T = expert_idx.shape[0]
        K = T // N
        i32 = dict(dtype=torch.int32, device=flat.device)
        kept = (slot_i < C).to(torch.int32)
        sizes = torch.zeros(E, **i32).scatter_add_(0, expert_idx.long(), kept)
        offs = torch.cat([torch.zeros(1, **i32),
                          torch.cumsum(sizes, 0, dtype=torch.int32)])
        drop = 1 - kept
        drop_rank = torch.cumsum(drop, 0, dtype=torch.int32) - drop
        dest = torch.where(kept > 0, offs[expert_idx.long()] + slot_i,
                           offs[E] + drop_rank).long()
        token_id = torch.arange(N, device=flat.device).repeat(K)
        src = torch.zeros(T, dtype=torch.long,
                          device=flat.device).scatter_(0, dest, token_id)
        xs = flat.index_select(0, src)                          # [T, D]
        ys = self.experts.apply_sorted(xs, sizes, eparams)
        y = ys.index_select(0, dest)                            # unpermute
        y = y * gate_p.to(y.dtype)[:, None]                     # kept-weighted
        self.expert_load = sizes.detach()
        return y.reshape(K, N, D).sum(dim=0)

    def _capacity(self, flat, expert_idx, slot_i, gate_p, eparams):
        N, D = flat.shape
        E = self.gate.num_experts
        C = self.gate.capacity(N)
        K = expert_idx.shape[0] // N
        token_id = torch.arange(N, device=flat.device).repeat(K)
        lin = expert_idx.long() * C + slot_i.long().clamp_max(C - 1)
        kept = slot_i < C
        # slot -> token map (N = the empty row; dropped pairs write a spare
        # last entry that is cut off)
        slot_token = torch.full((E * C + 1,), N, dtype=torch.long,
                                device=flat.device).scatter_(
            0, torch.where(kept, lin, E * C), token_id)[:E * C]
        flat_pad = torch.cat([flat, flat.new_zeros(1, D)])
        xe = flat_pad.index_select(0, slot_token).reshape(E, C, D)
        ye = self.experts.apply_raw(xe, eparams).reshape(E * C, D)
        picked = ye.index_select(0, lin)
        picked = picked * (gate_p * kept).to(flat.dtype)[:, None]
        return picked.reshape(K, N, D).sum(dim=0)
