"""Mixture-of-Experts feed-forward layer, the port of the JAX package's
``models/moe.py``: Switch top-1 or GShard top-k routing over
``n_experts`` two-layer FFNs with a fixed per-expert capacity ``C``.

Routing (``route``) follows the JAX layer step for step: router logits
and softmax in f32 whatever the compute dtype; top-1 takes ``argmax``
(the first maximum) and the chosen expert's raw probability as its
combine weight; top-k takes the k largest probabilities (ties to the
lower expert index, as ``lax.top_k``) renormalised.  Each choice rank r
claims queue slots after the ranks before it, one cumsum per rank, and a
token over capacity still uses up the position it tried (``counts`` grows
by the whole one-hot).  The load-balance aux is ``E * sum_e f_e * p_e``
on the rank-0 assignment.

Dispatch and combine move tokens by index where the JAX layer multiplies
by an (N, E, C) one-hot mask: the same slot positions (the same cumsum
rule) become indices into an (E * C + 1, d) slot table whose last row
takes every dropped token and is sliced off.  The dispatch is one
``index_copy`` (each kept (token, rank) pair writes its own slot), the
combine one gather per rank weighted by the combine weight (cast to the
compute dtype first, as JAX casts the combine mask), summed over the
ranks in order.  No ``nonzero``, no boolean indexing and no host sync, so
a CUDA graph captures the layer; no kept slot is written twice, so no
sum depends on the order of atomics.  :func:`dispatch_combine_onehot` is
the one-hot einsum form, the plain version the index form is held to.

Routing groups: capacity counts the tokens of one JAX device in one
``apply`` call, so the layer routes each group of tokens alone.  The
groups of the ``x`` given are its ``expert_shards`` row blocks (the
expert shards a ``parallel.expert.LocalExpertGroup`` holds in this
process, each with its own rows) times its ``seq_shards`` column blocks
(a ``LocalSeqGroup``'s shards), tokens in row-major order inside each;
``apply`` returns one aux per group.

Expert parallelism: ``expert_group`` (``parallel.expert``) moves the
(G, E, C, d) slots to the shards that own their experts and back: a
process group by ``all_to_all`` (JAX's ``all_to_all(tiled=True)``), a
local group, holding every expert, by regrouping the slots so each
expert's FFN runs once over every group's slots.  ``tensor_group``
(``parallel.megatron``) splits each expert's hidden dim: ``w_in`` /
``b_in`` / ``w_gate`` / ``b_gate`` by columns, ``w_out`` by rows, the
partial outputs summed by ``g`` before ``b_out``; ``f`` makes the
backward's sum of the slots' gradient explicit.  A process group's
leaves are already this rank's slices (``parallel.tensor_parallel.
StateLayout``); a local group's are whole and chunked here.

The expert products (``esd,edf->esf``, ``esf,efd->esd``) are batched
``torch.bmm`` calls in the compute dtype.  Weights-only int8 experts
(``ops.quant``: int8 ``w_*`` with f32 ``w_*_scale`` per (expert, column))
are dequantized in the product, the scale folded into its output.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .core import ACTIVATIONS, _uniform

Params = Dict[str, Any]

# the expert-FFN leaves whose hidden dim f a tensor group splits, and the
# dim of each (negative: from the end); b_out adds after the row sum
TENSOR_SPLIT_DIMS = {"w_in": -1, "b_in": -1, "w_gate": -1, "b_gate": -1,
                     "w_out": -2, "w_in_scale": -1, "w_gate_scale": -1}


@dataclass(frozen=True)
class Route:
    """One routing of G groups of n tokens: ``dest`` (G, k, n) int64, each
    (token, rank)'s row in its group's (E * C + 1)-row slot table (E * C:
    dropped); ``weight`` (G, k, n) f32 combine weights; ``aux`` (G,) f32;
    ``capacity`` C."""

    dest: torch.Tensor
    weight: torch.Tensor
    aux: torch.Tensor
    capacity: int


@dataclass(frozen=True)
class MoEFFN:
    """Top-k gated mixture of ``n_experts`` two-layer FFNs (see the module
    docstring).  ``capacity``: the per-group per-expert slot count;
    default ``ceil(capacity_factor * router_top_k * group_tokens /
    n_experts)``."""

    d_model: int
    d_ff: int
    n_experts: int
    capacity_factor: float = 1.25
    capacity: Optional[int] = None
    activation: str = "gelu"
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    router_top_k: int = 1

    def __post_init__(self):
        if not 1 <= self.router_top_k <= self.n_experts:
            raise ValueError(
                f"router_top_k must be in [1, n_experts={self.n_experts}], "
                f"got {self.router_top_k}")

    def init(self, generator: torch.Generator, device) -> Params:
        e, d, f = self.n_experts, self.d_model, self.d_ff
        bd, bf = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
        dt = self.param_dtype

        def u(shape, bound):
            return _uniform(shape, bound, dt, generator, device)

        gate = {"w": u((d, e), bd)}
        experts = {"w_in": u((e, d, f), bd), "b_in": u((e, f), bd),
                   "w_out": u((e, f, d), bf), "b_out": u((e, d), bf)}
        if self.activation == "swiglu":
            experts["w_gate"] = u((e, d, f), bd)
            experts["b_gate"] = u((e, f), bd)
        return {"gate": gate, "experts": experts}

    # ---- routing ----
    def _capacity(self, n_tokens: int) -> int:
        if self.capacity is not None:
            return self.capacity
        return max(1, math.ceil(self.capacity_factor * self.router_top_k
                                * n_tokens / self.n_experts))

    def route(self, gate_w: torch.Tensor, toks: torch.Tensor) -> Route:
        """``toks`` (G, n, d): G groups routed alone."""
        e, k = self.n_experts, self.router_top_k
        g, n, _ = toks.shape
        cap = self._capacity(n)
        logits = torch.matmul(toks.float(), gate_w.float())     # (G, n, E)
        probs = torch.softmax(logits, dim=-1)
        experts = torch.arange(e, device=toks.device)
        # top-k by repeated argmax: the first maximum each time, so ties
        # go to the lower expert index (lax.top_k's order)
        idx, left = [], probs.detach()
        for _ in range(k):
            i = left.argmax(dim=-1)                             # (G, n)
            idx.append(i)
            left = left.masked_fill(i[..., None] == experts, -1.0)
        top_p = torch.stack([probs.gather(-1, i[..., None])[..., 0]
                             for i in idx], dim=1)              # (G, k, n)
        if k == 1:
            weight = top_p          # Switch: the raw probability
        else:
            weight = top_p / torch.clamp(top_p.sum(1, keepdim=True),
                                         min=1e-9)
        counts = torch.zeros((g, e, 1), dtype=torch.int64,
                             device=toks.device)
        dest = []
        for i in idx:
            # (G, E, n): the token axis innermost, so the cumsum scans
            # contiguous rows (a scan over an outer axis runs one thread
            # per (group, expert) column on the card)
            onehot = (i[:, None, :] == experts[:, None]).long()
            pos = torch.cumsum(onehot, dim=-1) - 1 + counts
            pos_tok = pos.gather(1, i[:, None, :])[:, 0]       # (G, n)
            keep = pos_tok < cap
            dest.append(torch.where(keep, i * cap + pos_tok,
                                    torch.full_like(pos_tok, e * cap)))
            counts = counts + onehot.sum(-1, keepdim=True)
        top1 = (idx[0][..., None] == experts).float()
        aux = e * (top1.mean(1) * probs.mean(1)).sum(-1)       # (G,)
        return Route(torch.stack(dest, dim=1), weight, aux, cap)

    # ---- expert compute ----
    def _pieces(self, ep: Params, name: str, tensor_group) -> List:
        """The tensor shards of one expert leaf computed here: the leaf
        itself (no group, or a process group's slice), else a local
        group's chunks of the whole leaf."""
        leaf = ep[name]
        if tensor_group is None or hasattr(tensor_group, "pg"):
            return [leaf]
        dim = TENSOR_SPLIT_DIMS.get(name)
        if dim is None:
            return [leaf] * len(tensor_group.ranks)
        parts = leaf.chunk(tensor_group.size, dim=dim)
        return [parts[r] for r in tensor_group.ranks]

    def experts_ffn(self, ep: Params, slots: torch.Tensor,
                    tensor_group=None) -> torch.Tensor:
        """slots (E_local, S, d) -> (E_local, S, d): per expert
        ``act(x W_in + b_in) W_out + b_out`` (SwiGLU: ``silu(x W_gate +
        b_gate) * (x W_in + b_in)``), the hidden dim split over
        ``tensor_group``."""
        cdt = self.compute_dtype
        x = slots if tensor_group is None else tensor_group.f(slots)
        x = x.to(cdt)

        def hidden(parts):
            h = torch.bmm(x, parts["w_in"].to(cdt))
            if "w_in_scale" in parts:
                h = h * parts["w_in_scale"][:, None, :].to(cdt)
            h = h + parts["b_in"][:, None, :].to(cdt)
            if self.activation == "swiglu":
                gt = torch.bmm(x, parts["w_gate"].to(cdt))
                if "w_gate_scale" in parts:
                    gt = gt * parts["w_gate_scale"][:, None, :].to(cdt)
                gt = gt + parts["b_gate"][:, None, :].to(cdt)
                return F.silu(gt) * h
            return ACTIVATIONS[self.activation](h)

        names = [nm for nm in ep if nm not in ("b_out", "w_out_scale")]
        per_leaf = {nm: self._pieces(ep, nm, tensor_group) for nm in names}
        outs = []
        for t in range(len(per_leaf["w_in"])):
            parts = {nm: per_leaf[nm][t] for nm in names}
            out = torch.bmm(hidden(parts), parts["w_out"].to(cdt))
            if "w_out_scale" in ep:
                out = out * ep["w_out_scale"][:, None, :].to(cdt)
            outs.append(out)
        out = outs[0] if tensor_group is None else tensor_group.g(outs)
        return out + ep["b_out"][:, None, :].to(cdt)

    # ---- the layer ----
    def apply(self, params: Params, x: torch.Tensor, expert_group=None,
              tensor_group=None, seq_shards: int = 1,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, T, d) (or (N, d) with one group) -> (y in the compute
        dtype, aux (G,) f32), G = the expert shards ``expert_group`` holds
        here x ``seq_shards``."""
        cdt = self.compute_dtype
        shape, d = x.shape, x.shape[-1]
        g_e = 1 if expert_group is None else len(expert_group.ranks)
        groups = g_e * seq_shards
        if groups == 1:
            toks = x.reshape(1, -1, d)
        else:
            b, t = shape[0], shape[1]
            if b % g_e or t % seq_shards:
                raise ValueError(
                    f"(B, T) = ({b}, {t}) does not split into {g_e} expert "
                    f"x {seq_shards} sequence routing groups")
            toks = (x.reshape(g_e, b // g_e, seq_shards, t // seq_shards, d)
                    .transpose(1, 2).reshape(groups, -1, d))
        r = self.route(params["gate"]["w"], toks)
        g, n = toks.shape[:2]
        e, cap, k = self.n_experts, r.capacity, self.router_top_k
        rows = e * cap + 1
        # every group's table in one buffer: row g * rows + dest
        gdest = r.dest + (torch.arange(g, device=x.device)
                          * rows)[:, None, None]                 # (G, k, n)
        src = toks.to(cdt)[:, None].expand(g, k, n, d).reshape(-1, d)
        slots = torch.zeros((g * rows, d), dtype=cdt, device=x.device)
        slots = slots.index_copy(0, gdest.reshape(-1), src)
        slots = slots.view(g, rows, d)[:, :e * cap].reshape(g, e, cap, d)
        if expert_group is None:
            out = self.experts_ffn(
                params["experts"], _join_groups(slots), tensor_group)
            out = _split_groups(out, g)
        else:
            out = expert_group.combine(self.experts_ffn(
                params["experts"], expert_group.dispatch(slots),
                tensor_group), g)
        out = torch.cat([out.reshape(g, e * cap, d),
                         out.new_zeros((g, 1, d))], dim=1).reshape(-1, d)
        w = r.weight.to(cdt)
        y = None
        for j in range(k):
            term = (w[:, j].reshape(-1, 1)
                    * out.index_select(0, gdest[:, j].reshape(-1)))
            y = term if y is None else y + term
        y = y.view(g, n, d)
        if groups > 1:
            b, t = shape[0], shape[1]
            y = (y.view(g_e, seq_shards, b // g_e, t // seq_shards, d)
                 .transpose(1, 2))
        return y.reshape(shape).to(cdt), r.aux


def _join_groups(slots: torch.Tensor) -> torch.Tensor:
    """(G, E, C, d) -> (E, G * C, d): each expert's slots of every group,
    for one FFN call over all experts."""
    g, e, c, d = slots.shape
    return slots.transpose(0, 1).reshape(e, g * c, d)


def _split_groups(out: torch.Tensor, g: int) -> torch.Tensor:
    """The inverse of :func:`_join_groups`."""
    e, s, d = out.shape
    return out.reshape(e, g, s // g, d).transpose(0, 1)


def dispatch_combine_onehot(layer: MoEFFN, params: Params, x: torch.Tensor,
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX layer's one-hot einsum form on one routing group (no
    expert or tensor group): the (N, E, C) dispatch and combine masks
    built from :meth:`MoEFFN.route`'s slots, ``nec,nd->ecd`` in, the
    experts, ``nec,ecd->nd`` out.  The plain version the index form is
    held to."""
    cdt = layer.compute_dtype
    shape, d = x.shape, x.shape[-1]
    toks = x.reshape(1, -1, d)
    r = layer.route(params["gate"]["w"], toks)
    e, cap = layer.n_experts, r.capacity
    n = toks.shape[1]
    slot_ids = torch.arange(e * cap, device=x.device)
    dispatch = x.new_zeros((n, e * cap), dtype=torch.float32)
    combine = torch.zeros_like(dispatch)
    for j in range(layer.router_top_k):
        mask = (r.dest[0, j][:, None] == slot_ids).float()
        dispatch = dispatch + mask
        combine = combine + mask * r.weight[0, j][:, None]
    dispatch = dispatch.view(n, e, cap)
    combine = combine.view(n, e, cap)
    slots = torch.einsum("nec,nd->ecd", dispatch.to(cdt), toks[0].to(cdt))
    out = layer.experts_ffn(params["experts"], slots)
    y = torch.einsum("nec,ecd->nd", combine.to(cdt), out)
    return y.reshape(shape).to(cdt), r.aux
