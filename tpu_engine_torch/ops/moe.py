"""Mixture-of-Experts FFN (counterpart of ``tpu_engine/ops/moe.py``): a
softmax router with top-k gating and static capacity slots, in plain
PyTorch matrix products.

The form is the JAX function's dense one-hot one: tokens route through a
(N, E, C) dispatch tensor built by capacity-slot assignment (the
exclusive cumsum over the token order per expert, pairs past capacity
dropped), the experts run as batched products over the stacked (E, ...)
weights, and a combine tensor of the same shape returns their outputs
weighted by the gates. N is every token of the call, B x T, padding
included: slots go out in row-major token order, so under drops a
token's output depends on the tokens before it in the call, and the
forwards hand this function JAX's shapes and padding.

The dtypes follow JAX's promotion step by step: the router's logits are
f32 (``nn.dense`` of the gate with a zero bias), the gates are rounded to
the compute dtype with the dispatch and combine tensors, the expert
products run in the compute dtype, GELU is the tanh form
(``jax.nn.gelu``'s default), and an int8 expert stack's f32 scale
promotes its product, and the combine after it, to f32. The result is
cast to x's dtype.

Expert parallelism: ``shard_moe_params`` gives JAX's shardings (a leaf
whose path names ``wi`` or ``wo`` splits dim 0, the experts, over the
``expert`` axis; every other leaf is whole), and ``moe_apply`` over the
``MeshTree`` that ``place(params, shard_moe_params(params, mesh))``
gives runs the router, the dispatch and the combine on ``mesh.home`` and
each rank's E/n experts on its own device; the expert outputs gather
along E in rank order. The slots are the unsharded call's, drops
included.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from tpu_engine_torch.ops import nn
from tpu_engine_torch.parallel.mesh import (
    Mesh,
    MeshTree,
    Sharding,
    unflatten_tree,
)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert slot count for a call of ``n_tokens``."""
        c = int(self.capacity_factor * self.top_k * n_tokens / self.n_experts)
        return max(1, min(c, n_tokens))


def moe_init(cfg: MoEConfig, generator: torch.Generator, device,
             dtype=torch.float32):
    """Seeded random weights with ``moe_init``'s distributions: the gate
    N(0, 1/d), the stacked expert FFNs wi (E, d, f) N(0, 1/d) and wo
    (E, f, d) N(0, 1/f), drawn in f32 and stored in ``dtype``; the numbers
    are not JAX's."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def normal(shape, std):
        t = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (t * std).to(dtype)

    return {"gate": {"kernel": normal((d, e), 1.0 / math.sqrt(d))},
            "wi": normal((e, d, f), 1.0 / math.sqrt(d)),
            "wo": normal((e, f, d), 1.0 / math.sqrt(f))}


def route(probs: torch.Tensor, cfg: MoEConfig, n_tokens: int):
    """(dispatch, combine), each (N, E, C) f32, from the router's f32
    probabilities (N, E): k rounds of argmax (ties to the first index; a
    chosen expert's probability is zeroed, so a later round may pick one
    of probability 0), the kept gates renormalized by max(sum, 1e-9), and
    each chosen (token, expert) pair given the expert's next slot in
    token order, rank by rank; a pair at or past capacity is dropped."""
    n, e = probs.shape
    cap = cfg.capacity(n_tokens)
    gates = torch.zeros_like(probs)
    masks = []
    p = probs
    for _ in range(cfg.top_k):
        idx = torch.argmax(p, dim=-1)
        onehot = torch.nn.functional.one_hot(idx, e).to(probs.dtype)
        masks.append(onehot)
        gates = gates + probs * onehot
        p = p * (1.0 - onehot)
    denom = torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    gates = gates / denom
    slots = torch.arange(cap, device=probs.device, dtype=torch.float32)
    dispatch = torch.zeros((n, e, cap), dtype=torch.float32,
                           device=probs.device)
    combine = torch.zeros_like(dispatch)
    prior = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    for onehot in masks:
        pos = torch.cumsum(onehot, dim=0) - onehot + prior[None, :]  # (N, E)
        prior = prior + onehot.sum(dim=0)
        in_cap = (pos < cap).float() * onehot
        # jax.nn.one_hot of a position >= cap is an all-zero row, which
        # torch's one_hot refuses: compare with the slot indices instead.
        slot = (pos[..., None] == slots).float()                  # (N, E, C)
        sel = in_cap[..., None] * slot
        dispatch = dispatch + sel
        combine = combine + sel * gates[..., None]
    return dispatch, combine


def _dispatch_tensors(logits: torch.Tensor, cfg: MoEConfig, n_tokens: int):
    """(dispatch, combine) (N, E, C) from router logits (N, E): softmax in
    f32, then ``route``."""
    probs = torch.softmax(logits.float(), dim=-1)
    return route(probs, cfg, n_tokens)


def _expert_product(spec: str, x, params, name: str, dtype):
    """One expert product in the compute dtype; an int8 stack's f32
    per-(expert, out-channel) scale multiplies its output (an f32
    result)."""
    if f"{name}_q" in params:
        y = torch.einsum(spec, x, params[f"{name}_q"].to(dtype))
        return y * params[f"{name}_scale"][:, None, :]
    return torch.einsum(spec, x, params[name].to(dtype))


def _experts(params, expert_in, dtype):
    """The expert FFNs over their slots: (E', C, d) -> (E', C, d) for the
    E' experts whose stacks ``params`` holds."""
    h = _expert_product("ecd,edf->ecf", expert_in, params, "wi", dtype)
    h = nn.gelu(h, approximate=True)
    return _expert_product("ecf,efd->ecd", h.to(dtype), params, "wo",
                           dtype)


def _experts_parallel(placed: MeshTree, expert_in, dtype):
    """``_experts`` with the stacks split over the experts: the ranks at
    each index of the split axis (0 on every other axis) run their E/n
    experts on their devices; the outputs gather along E in rank order
    on ``expert_in``'s device."""
    mesh = placed.mesh
    axis = next(s.axis for s in placed.shardings if s.axis is not None)
    n = mesh.shape[axis]
    parts = []
    for i, chunk in enumerate(expert_in.chunk(n, 0)):
        r = mesh.rank(**{axis: i})
        parts.append(_experts(placed.local(r), chunk.to(mesh.devices[r]),
                              dtype))
    return Mesh.gather(parts, 0, expert_in.device)


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig,
              dtype=torch.bfloat16) -> torch.Tensor:
    """x (B, T, d_model) -> (B, T, d_model): the dense-dispatch MoE FFN
    over every B x T token. ``params``: ``{"gate": {"kernel"}, "wi",
    "wo"}`` or its int8 form (``wi_q``/``wi_scale``,
    ``wo_q``/``wo_scale``; the gate stays full precision), or that tree
    placed on a mesh by ``shard_moe_params`` (expert parallelism: the
    router, dispatch and combine on ``mesh.home``, the result on x's
    device)."""
    placed = params if isinstance(params, MeshTree) else None
    home = x.device
    if placed is not None:
        home = placed.mesh.home
        params = placed.local(0)
    b, t, d = x.shape
    n = b * t
    xf = x.reshape(n, d).to(home)
    gate = dict(params["gate"])
    gate.setdefault("bias", torch.zeros((cfg.n_experts,),
                                        dtype=torch.float32,
                                        device=home))
    logits = nn.dense(gate, xf, dtype=dtype)
    dispatch, combine = _dispatch_tensors(logits, cfg, n)
    xc = xf.to(dtype)
    expert_in = torch.einsum("nd,nec->ecd", xc, dispatch.to(dtype))
    expert_out = (_experts(params, expert_in, dtype) if placed is None
                  else _experts_parallel(placed, expert_in, dtype))
    # The gates round to the compute dtype, then promote with an f32
    # expert output (the int8 form), as JAX's einsum promotes them.
    out = torch.einsum("ecd,nec->nd", expert_out,
                       combine.to(dtype).to(expert_out.dtype))
    return out.reshape(b, t, d).to(x.device, x.dtype)


def _path_names(tree, prefix=()):
    """(path, leaf) of every leaf, dicts in insertion order."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items()
                for pl in _path_names(v, prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _path_names(v, prefix + (str(i),))]
    return [(prefix, tree)]


def shard_moe_params(params, mesh: Mesh, axis: str = "expert"):
    """JAX's ``shard_moe_params`` as the port's ``Sharding``s, a tree of
    ``params``' structure: a leaf whose path names ``wi`` or ``wo`` (so
    also ``wi_q``, ``wi_scale``, ``wo_q``, ``wo_scale``) splits dim 0,
    the experts, over ``axis``; every other leaf is whole on every rank.
    ``place(params, shard_moe_params(params, mesh))`` gives the tree that
    ``moe_apply`` runs expert-parallel."""
    shardings = []
    for path, _leaf in _path_names(params):
        name = "/".join(path)
        shardings.append(Sharding(mesh, axis, 0)
                         if "wi" in name or "wo" in name else Sharding(mesh))
    return unflatten_tree(params, shardings)
