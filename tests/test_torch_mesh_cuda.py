"""Mesh-sharded serving and training on the card: every mesh rank on one
card (``parse_mesh_spec(spec, device="cuda:0")``), llama-small-test in
f32 with TF32 off.

- The mesh engine at model=2,data=2 answers the single-rank engine on the
  same weights within 1e-5 of the largest logit, and each dispatch
  launches #5 once per layer and data rank, with no plain call.
- A mesh train step (data=2,model=2) gives the unsharded step's loss
  within 1e-5 relative and launches #5, #6 and #7 once per layer and data
  rank.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_mesh_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.models.transformer import transformer_apply
from tpu_engine_torch.ops import flash, kernels
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.serving.app import _mesh_engine, parse_mesh_spec
from tpu_engine_torch.training import train as ttrain
from tpu_engine_torch.utils.config import WorkerConfig

MODEL = "llama-small-test"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the mesh paths' kernels on the "
                    "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_mesh_engine_on_one_card(card):
    spec = create_model(MODEL)
    params = spec.init(0, device=card, dtype="float32")
    mesh = parse_mesh_spec("model=2,data=2", device="cuda:0")
    eng = _mesh_engine(MODEL, WorkerConfig(model=MODEL, dtype="float32",
                                           batch_buckets=(8,)), mesh,
                       params=params)
    rng = np.random.default_rng(0)
    rows = [rng.integers(1, 200, int(n)).astype(np.float32)
            for n in rng.integers(3, 15, 8)]
    kernels.reset_counts()
    got = np.stack(eng.batch_predict(rows))
    assert flash.flash_attention_fwd.launches == spec.config.n_layers * 2
    assert flash.flash_attention_fwd.plain_calls == 0
    one = InferenceEngine(spec, params=params, dtype="float32",
                          batch_buckets=(8,), device=card)
    want = np.stack(one.batch_predict(rows))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.cuda
def test_mesh_train_step_on_one_card(card):
    cfg = create_model(MODEL).config

    def apply_fn(p, x, dtype=torch.float32):
        return transformer_apply(p, x, cfg, dtype=dtype)

    init_state, step = ttrain.make_train_step(
        apply_fn, loss_fn=ttrain.cross_entropy_loss,
        optimizer=ttrain.adamw(1e-3), dtype=torch.float32)
    mesh = parse_mesh_spec("data=2,model=2", device="cuda:0")
    place_state, mesh_step = ttrain.make_mesh_train_step(
        apply_fn, mesh, loss_fn=ttrain.cross_entropy_loss,
        dtype=torch.float32)
    batch = torch.from_numpy(np.random.default_rng(1).integers(
        1, cfg.vocab, (4, 65))).to(card)
    plain = init_state(create_model(MODEL).init(0, device=card,
                                                dtype="float32"))
    full = init_state(create_model(MODEL).init(0, device=card,
                                               dtype="float32"))
    placed = place_state(full, ttrain.shard_params_tp(full.params, mesh))
    _, want = step(plain, batch[:, :-1], batch[:, 1:])
    kernels.reset_counts()
    _, got = mesh_step(placed, batch[:, :-1], batch[:, 1:])
    for fn in (flash.flash_attention_fwd, flash.flash_attention_bwd_dq,
               flash.flash_attention_bwd_dkv):
        assert fn.launches == cfg.n_layers * 2 and fn.plain_calls == 0
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
