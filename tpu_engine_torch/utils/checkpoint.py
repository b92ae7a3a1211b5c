"""Checkpoint and resume (counterpart of ``tpu_engine/utils/checkpoint.py``)
in the port's own format: a directory holding one ``torch.save`` file, read
back with ``torch.load(weights_only=True)``.

- ``save_params``/``load_params``: a parameter tree (``<path>/params.pt``),
  the artifact a worker serves (``cli worker <port> <id> <path>`` with the
  ``tpu_engine_model.json`` sidecar the ``train`` command writes).
- ``save_train_state``/``load_train_state``: the whole ``TrainState``
  (``<path>/state.pt``): parameters, the optimizer's per-leaf state and
  the step, so training resumes exactly where it stopped.

``overwrite`` replaces an existing checkpoint atomically, as orbax does:
the new one is written to a temporary directory beside it, which then
takes its place by ``os.replace``, so a crash mid-save leaves the old or
the new checkpoint, never neither. orbax checkpoints of the JAX package are
not read here (orbax imports jax); ``models.convert`` carries a JAX
parameter tree or train state across as numpy arrays. The JAX package's
``enable_compilation_cache`` has no counterpart: nothing is compiled by
XLA.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch

from tpu_engine_torch.training.train import TrainState, tree_leaves, tree_map
from tpu_engine_torch.utils.device import resolve_device, resolve_dtype

PARAMS_FILE = "params.pt"
STATE_FILE = "state.pt"
# Beside a servable params.pt: {"model": registry name, "kwargs": its
# factory's arguments (optional)}, written by the train and import-weights
# commands.
SIDECAR = "tpu_engine_model.json"


def _save(path: str, name: str, payload, overwrite: bool) -> str:
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"checkpoint {path} exists (pass "
                              f"overwrite=True to replace it)")
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    old = f"{path}.old-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, name))
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path


def _detached(tree):
    return tree_map(lambda t: t.detach(), tree)


def save_params(path: str, params: Any, overwrite: bool = False) -> str:
    """Save a parameter tree to the directory ``path`` (created; it must
    not exist unless ``overwrite``). Returns the absolute path."""
    return _save(path, PARAMS_FILE, _detached(params), overwrite)


def load_params(path: str, device=None, dtype=None) -> Any:
    """Restore a parameter tree onto ``device`` (None = the CUDA card).
    ``dtype``, if given, is the matmul kernels' dtype (the
    ``models.convert`` convention, MoE expert stacks included: everything
    else, int8 kernels and their scales too, stays as saved)."""
    tree = torch.load(os.path.join(os.path.abspath(path), PARAMS_FILE),
                      map_location=resolve_device(device), weights_only=True)
    return tree if dtype is None else _cast_kernels(tree,
                                                    resolve_dtype(dtype))


def _cast_kernels(tree, dtype):
    if isinstance(tree, dict):
        return {k: (v.to(dtype) if k in ("kernel", "wi", "wo")
                    and torch.is_tensor(v)
                    else _cast_kernels(v, dtype)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_kernels(v, dtype) for v in tree]
    return tree


def save_train_state(path: str, state: TrainState,
                     overwrite: bool = False) -> str:
    """Save a ``TrainState``: parameters, the optimizer's state dict (its
    per-leaf state and hyperparameters) and the step."""
    if not isinstance(state, TrainState):
        raise TypeError(f"expected a TrainState, got {type(state).__name__}")
    payload = {"params": _detached(state.params),
               "opt_state": state.opt_state.state_dict(),
               "step": int(state.step)}
    return _save(path, STATE_FILE, payload, overwrite)


def load_train_state(path: str, like: TrainState) -> TrainState:
    """Restore a ``TrainState`` into ``like`` (a freshly initialized state
    of the same model and optimizer, as the JAX function's ``like``): its
    parameter leaves are overwritten in place, its optimizer loads the
    saved state, its step is set. Returns ``like``."""
    file = os.path.join(os.path.abspath(path), STATE_FILE)
    got = torch.load(file, map_location="cpu", weights_only=True)
    saved, leaves = tree_leaves(got["params"]), tree_leaves(like.params)
    if len(saved) != len(leaves):
        raise ValueError(f"{file} holds {len(saved)} parameter leaves, like "
                         f"has {len(leaves)}")
    with torch.no_grad():
        for src, dst in zip(saved, leaves):
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{file}: leaf {src.dtype} "
                                 f"{tuple(src.shape)} does not match "
                                 f"{dst.dtype} {tuple(dst.shape)}")
            dst.copy_(src)
    like.opt_state.load_state_dict(got["opt_state"])
    like.step = int(got["step"])
    return like
