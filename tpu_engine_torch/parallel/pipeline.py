"""Pipeline parallelism of the port (counterpart of
``tpu_engine/parallel/pipeline.py``): GPipe microbatching over a
``stage`` axis of a ``parallel.mesh.Mesh``.

Stage s owns layers [s·L/S, (s+1)·L/S) on the device of the rank at s on
``axis_name`` (0 on every other axis). The batch splits into M
microbatches of contiguous rows; at step t stage s applies its layers to
microbatch t - s and hands the result to stage s + 1 with ``.to`` its
device (JAX's ``ppermute``). The schedule takes M + S - 1 steps and the
last stage's outputs land, in microbatch order, on ``mesh.home``.

JAX computes the bubble steps and discards their work, the price of one
compiled program; an eager schedule skips them, so each layer runs once
per microbatch and the result does not change.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from tpu_engine_torch.parallel.mesh import Mesh, flatten_tree, unflatten_tree


def _layers(stacked_params) -> List:
    """Per-layer trees: the port's list of them as it is, or a tree of
    (L, ...) tensors split along dim 0 (JAX's stacked form)."""
    if isinstance(stacked_params, (list, tuple)):
        return list(stacked_params)
    leaves = flatten_tree(stacked_params)
    return [unflatten_tree(stacked_params, [t[i] for t in leaves])
            for i in range(leaves[0].shape[0])]


def _to(tree, device):
    return unflatten_tree(tree, [t.to(device) for t in flatten_tree(tree)])


def pipeline_apply(block_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh: Mesh, *, axis_name: str = "stage",
                   n_microbatches: Optional[int] = None) -> torch.Tensor:
    """Run ``block_fn(layer_params, h) -> h`` over L layers as an S-stage
    pipeline (JAX's contract). stacked_params: a list of per-layer trees
    or a tree of (L, ...) tensors, L % S == 0; a layer's tensors move to
    its stage's device (a no-op where they lie). x: (B, ...), B % M == 0
    (M defaults to S). Returns (B, ...) on ``mesh.home``, as the plain
    loop over the layers gives it."""
    n_stages = mesh.shape[axis_name]
    n_micro = n_microbatches or n_stages
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    layers = _layers(stacked_params)
    if len(layers) % n_stages != 0:
        raise ValueError(f"{len(layers)} layers not divisible by {n_stages} "
                         f"stages")
    per = len(layers) // n_stages
    devices = [mesh.devices[mesh.rank(**{axis_name: s})]
               for s in range(n_stages)]
    stages = [[_to(lp, devices[s]) for lp in layers[s * per:(s + 1) * per]]
              for s in range(n_stages)]
    micro = x.chunk(n_micro, 0)
    held = {}   # microbatch -> its activation, on the next stage's device
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        # Later stages first: each takes what its predecessor handed on at
        # the step before.
        for s in reversed(range(n_stages)):
            i = t - s
            if not 0 <= i < n_micro:
                continue  # a bubble
            h = micro[i].to(devices[0]) if s == 0 else held.pop(i)
            for lp in stages[s]:
                h = block_fn(lp, h)
            if s == n_stages - 1:
                outs[i] = h.to(mesh.home)
            else:
                held[i] = h.to(devices[s + 1])
    return torch.cat(outs, 0)
