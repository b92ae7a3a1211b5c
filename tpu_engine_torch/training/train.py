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

The tensor-parallel placement (``shard_params_tp``, ``replicated_tree``)
is not ported: parallel training is later work.
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
