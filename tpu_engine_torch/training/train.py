"""The training step on one card (counterpart of
``tpu_engine/training/train.py``): ``TrainState``, the losses, and
``make_train_step`` with AdamW.

Parameters stay the port's dict tree (``models.convert``); the optimizer
takes its leaves in a fixed order (``tree_leaves``: dict keys sorted,
``blocks`` in layer order), so its per-leaf state lines up with the tree
and with the JAX package's optimizer state (``models.convert``'s
``train_state_from_jax``). The step runs forward, loss, backward (through
the flash backward kernels on the card) and the optimizer update, and
updates the state in place: parameters, gradients and AdamW's moments are
each held once, as the JAX CLI's donated state is.

Mesh training (the JAX train command's ``--mesh``): ``shard_params_tp``
and ``replicated_tree`` give the placement (``parallel.mesh``
``Sharding`` trees), and ``make_mesh_train_step`` runs the step of one
state over a ``data`` x ``model`` mesh. Each data rank runs forward and
backward on its slice of the batch, its parameters gathered from the
model ranks' shards on its device; the ranks' outputs are gathered in row
order and the loss is the whole batch's; each rank's gradients of a shard
are summed over ``data`` in rank order, in f32, onto the shard's owner
(the rank at data index 0), and the optimizer steps the owners, whose
values then refresh every other copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch


@dataclasses.dataclass
class TrainState:
    """``params``: the parameter tree, leaves requiring grad;
    ``opt_state``: the optimizer over ``tree_leaves(params)``, which holds
    each leaf's state (for AdamW ``step``, ``exp_avg``, ``exp_avg_sq``,
    the counterparts of optax's ``count``, ``mu`` and ``nu``); ``step``:
    optimizer steps taken."""
    params: Any
    opt_state: torch.optim.Optimizer
    step: int = 0


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a parameter tree in a fixed order: dict keys sorted,
    lists in order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``tree`` with every tensor replaced by ``fn(tensor)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cross_entropy_loss(logits, labels):
    """Mean token-level cross entropy; labels < 0 are masked (padding)."""
    mask = (labels >= 0).float()
    safe = labels.clamp(min=0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def mse_loss(outputs, targets):
    return ((outputs.float() - targets.float()) ** 2).mean()


def adamw(learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """The counterpart of ``optax.adamw`` with its defaults: a factory of
    ``torch.optim.AdamW`` over a list of leaves. Every leaf decays (optax's
    ``mask`` is None); both apply the same bias correction and decay the
    weights by lr * weight_decay * p from the pre-update value."""
    def make(leaves):
        return torch.optim.AdamW(leaves, lr=learning_rate, betas=(b1, b2),
                                 eps=eps, weight_decay=weight_decay)
    return make


def make_train_step(apply_fn: Callable, loss_fn: Callable = mse_loss,
                    optimizer: Optional[Callable] = None,
                    dtype=torch.bfloat16):
    """Build (init_state, train_step). ``apply_fn(params, x, dtype=...)`` is
    a model apply; ``loss_fn(outputs, targets)`` a scalar loss;
    ``optimizer`` a factory of a torch optimizer over a list of leaves
    (default ``adamw(1e-3)``).

    ``init_state(params)`` marks the leaves as requiring grad (in place) and
    builds the optimizer; ``train_step(state, x, targets)`` returns
    ``(state, loss)``, the state updated in place and the loss a detached
    0-d tensor (reading it synchronizes with the card)."""
    optimizer = optimizer or adamw(1e-3)

    def init_state(params) -> TrainState:
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        return TrainState(params=params, opt_state=optimizer(leaves), step=0)

    def train_step(state: TrainState, x, targets):
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(apply_fn(state.params, x, dtype=dtype), targets)
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        state.step += 1
        return state, loss.detach()

    return init_state, train_step


# -- mesh training ---------------------------------------------------------------

def shard_params_tp(params, mesh, axis: str = "model"):
    """The tensor-parallel placement of a parameter tree on ``mesh`` (the
    JAX function's: the registry's ``dense_output`` rule): kernels of 2+
    dims split their output-feature dim over ``axis``, divisible 1-D
    leaves of more than one element split too, the rest is whole on every
    rank. A tree of ``parallel.mesh.Sharding``. A weight-quantized tree
    refuses with the JAX registry's message."""
    from tpu_engine_torch.models.registry import TP_RULES
    from tpu_engine_torch.parallel.mesh import Sharding

    dims = TP_RULES["dense_output"](params, mesh.shape[axis])
    return tree_map(lambda d: Sharding(mesh) if d is None
                    else Sharding(mesh, axis, d), dims)


def replicated_tree(params, mesh):
    """Every leaf of ``params`` whole on every rank of ``mesh``."""
    from tpu_engine_torch.parallel.mesh import replicated

    return tree_map(lambda _leaf: replicated(mesh), params)


def make_mesh_train_step(apply_fn: Callable, mesh,
                         loss_fn: Callable = mse_loss,
                         dtype=torch.bfloat16):
    """Build (place_state, train_step) for ``mesh``.

    ``place_state(state, shardings)`` places a whole ``TrainState`` (made
    by ``make_train_step``'s ``init_state``, or restored into one from a
    checkpoint): its parameters by ``shardings`` (``shard_params_tp`` or
    ``replicated_tree``) into a ``parallel.mesh.MeshTree``, and each
    leaf's optimizer moments by the same placement, onto a new optimizer
    of the same kind and hyperparameters over the owners' shards. The
    placed state takes the given one's storage over (a leaf, a chunk or a
    moment already on its rank's device is not copied): step only the
    placed one. ``train_step(state, x, targets)`` returns ``(state, loss)`` as
    ``make_train_step``'s does: ``x`` splits over ``data`` (its rows
    must divide by the axis), the targets stay whole on the mesh's home
    device. ``gather_train_state`` turns a placed state back into one."""
    from tpu_engine_torch.parallel.mesh import flatten_tree, place

    def place_state(state: TrainState, shardings) -> TrainState:
        params = place(state.params, shardings)
        if any(s.axis == "data" for s in params.shardings):
            raise ValueError("parameters split over 'data' are not "
                             "supported by the mesh train step")
        owned = params.owned()
        owners = [params.ranks[r][i] for i, r in owned]
        for t in owners:
            t.requires_grad_(True)
        old = state.opt_state
        opt = _like(old, owners)
        if old.state:
            # Moments placed like their leaves; a shard's moments are the
            # chunks of the whole leaf's.
            flat = flatten_tree(state.params)
            for name in ("exp_avg", "exp_avg_sq"):
                m = place([old.state[t][name] for t in flat],
                          params.shardings)
                for (i, r), t in zip(owned, owners):
                    opt.state[t].setdefault(
                        "step", old.state[flat[i]]["step"].clone())
                    opt.state[t][name] = m.ranks[r][i]
        return TrainState(params=params, opt_state=opt, step=state.step)

    def train_step(state: TrainState, x, targets):
        params, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        # Each rank reads aliases of its leaves, so that each rank's
        # gradient of a shard stays apart until the sum over data.
        alias = [[t.detach().requires_grad_() for t in leaves]
                 for leaves in params.ranks]
        outs = [apply_fn(params.gathered(r, alias), xr, dtype=dtype)
                for r, xr in zip(mesh.data_ranks(), mesh.scatter_batch(x))]
        loss = loss_fn(mesh.gather_batch(outs), targets.to(mesh.home))
        loss.backward()
        for i, r in params.owned():
            at = mesh.coords(r)
            grads = [alias[mesh.rank(**{**at, "data": d})][i].grad
                     for d in range(mesh.shape["data"])]
            grads = [g for g in grads if g is not None]
            if grads:
                owner = params.ranks[r][i]
                owner.grad = mesh.sum_f32(grads, owner.device).to(
                    owner.dtype)
        opt.step()
        opt.zero_grad(set_to_none=True)
        params.sync()
        state.step += 1
        return state, loss.detach()

    return place_state, train_step


def _like(opt: torch.optim.Optimizer, leaves) -> torch.optim.Optimizer:
    """An optimizer of ``opt``'s kind over ``leaves``, with the
    hyperparameters of ``opt``'s first group and no state."""
    new = type(opt)(leaves)
    new.param_groups[0].update({k: v for k, v in opt.param_groups[0].items()
                                if k != "params"})
    return new


def gather_train_state(state: TrainState) -> TrainState:
    """A ``make_mesh_train_step`` state as one ``TrainState`` on the mesh's
    home device: every leaf and its moments gathered from the owners'
    shards, an optimizer of the same kind over ``tree_leaves`` of the
    whole tree (what ``make_train_step`` holds, so it saves and resumes
    as an unsharded run's)."""
    from tpu_engine_torch.parallel.mesh import flatten_tree

    params, opt = state.params, state.opt_state
    with torch.no_grad():
        whole = tree_map(lambda t: t.detach().clone(), params.gathered(0))
    leaves = tree_leaves(whole)
    for t in leaves:
        t.requires_grad_(True)
    new = _like(opt, leaves)
    if opt.state:
        flat = flatten_tree(whole)
        n, size = len(params.shardings), params.mesh.size
        for name in ("exp_avg", "exp_avg_sq"):
            per_rank = [[opt.state[params.ranks[params.owner(r, i)][i]][name]
                         for i in range(n)] for r in range(size)]
            with torch.no_grad():
                moments = flatten_tree(
                    params.with_ranks(per_rank).gathered(0))
            for i, t in enumerate(flat):
                new.state[t][name] = moments[i].clone()
        for i, t in enumerate(flat):  # rank 0 owns a shard of each leaf
            new.state[t]["step"] = opt.state[params.ranks[0][i]][
                "step"].clone()
    return TrainState(params=whole, opt_state=new, step=state.step)
