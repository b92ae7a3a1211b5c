"""The window-scan kernel (csrc/ssd_scan.cu, ``ops.ssd.ssd_scan``) on the
card against its plain version (``ssd_scan_reference``, the loop over the
slots, run on the same card tensors), f32, at the mamba2 geometry (d_inner
1536, 24 heads of 64, d_state 64, d_conv 4) and at ssd-small-test's:

- within 1e-4 of max(1, the largest plain magnitude) on y and on the
  states: the two sum the conv, the state update and the readout in other
  orders (the kernel contracts multiply-adds, the plain version's einsum
  reduces by its own tree);
- bit-identical over two runs;
- partition-invariant: one W-slot launch against W one-slot launches,
  states and y bit-equal;
- rows with qlen 0 and the null row 0 come back untouched, bit for bit;
- ssd-small-test served through a mixed and a two-path lane on the card
  gives the CPU's greedy streams, with 2 launches (its layers) per window
  scan and no plain call.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax, so the card's machine runs it without
the JAX package:

    python -m pytest --noconftest -q tests/test_torch_ssd_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu_engine_torch.models import ssd as tssd
from tpu_engine_torch.models.convert import params_to
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import kernels
from tpu_engine_torch.ops import ssd as tops
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

TOL = 1e-4
MAMBA2 = dict(d_inner=1536, d_state=64, n_heads=24)
SMALL = dict(d_inner=128, d_state=16, n_heads=4)
CASES = {"B8 W1": (8, 1, [1] * 8, MAMBA2),
         "B1 W64": (1, 64, [64], MAMBA2),
         "B8 W32 ragged": (8, 32, [32, 1, 0, 17, 5, 1, 32, 9], MAMBA2),
         "small B4 W8 ragged": (4, 8, [8, 0, 3, 1], SMALL)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the scan kernel has no CPU mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _inputs(case, seed=0):
    b, w, qlen, geo = CASES[case]
    arrs = tops.scan_parity_inputs(b, w, seed=seed, **geo)
    dev = torch.device("cuda")
    proj, state, ids, *weights = (torch.from_numpy(a).to(dev) for a in arrs)
    return (proj, state, ids, torch.tensor(qlen, dtype=torch.int32,
                                           device=dev), weights,
            geo["d_state"], geo["n_heads"])


def _run(fn, proj, state, ids, qlen, weights, n, h):
    st = state.clone()
    y = fn(proj, st, ids, qlen, *weights, n, h)
    torch.cuda.synchronize()
    return y, st


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_and_is_deterministic(card, case):
    proj, state, ids, qlen, weights, n, h = _inputs(case)
    y, st = _run(tops.ssd_scan, proj, state, ids, qlen, weights, n, h)
    ry, rst = _run(tops.ssd_scan_reference, proj, state, ids, qlen,
                   weights, n, h)
    for got, want in ((y, ry), (st, rst)):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= TOL * scale, case
    y2, st2 = _run(tops.ssd_scan, proj, state, ids, qlen, weights, n, h)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    # qlen-0 rows, every row outside the batch and the null row: untouched.
    live = set(ids[qlen > 0].tolist())
    for r in range(state.shape[0]):
        if r not in live:
            assert torch.equal(st[r], state[r]), (case, r)
    assert not y[qlen == 0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["B1 W64", "B8 W32 ragged",
                                  "small B4 W8 ragged"])
def test_kernel_partition_invariant(card, case):
    proj, state, ids, qlen, weights, n, h = _inputs(case, seed=1)
    y, st = _run(tops.ssd_scan, proj, state, ids, qlen, weights, n, h)
    steps = state.clone()
    ys = []
    for j in range(proj.shape[1]):
        ql = (qlen > j).to(torch.int32)
        ys.append(tops.ssd_scan(proj[:, j:j + 1].contiguous(), steps, ids,
                                ql, *weights, n, h))
    torch.cuda.synchronize()
    assert torch.equal(st, steps)
    assert torch.equal(y, torch.cat(ys, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mixed", "two-path"])
def test_small_model_lanes_equal_cpu(card, mode):
    spec = create_model("ssd-small-test")
    params = spec.init(3, "cpu", "float32")
    kw = dict(dtype="float32", n_slots=4, prefill_chunk=8, step_chunk=4)
    if mode == "mixed":
        kw.update(mixed_step=True, mixed_token_budget=8)
    prompts = [[5, 9, 3], [(i * 7) % 200 + 1 for i in range(40)], [7] * 20]
    outs = {}
    for dev in ("cpu", "cuda"):
        kernels.reset_counts()
        tssd.ssd_window_scan_rows.calls = 0
        gen = ContinuousGenerator(spec, params=params_to(params, dev),
                                  device=dev, **kw)
        try:
            outs[dev] = gen.generate(prompts, max_new_tokens=12)
        finally:
            gen.stop()
        if dev == "cuda":
            assert tops.ssd_scan.plain_calls == 0
            assert tops.ssd_scan.launches == (
                spec.config.n_layers * tssd.ssd_window_scan_rows.calls) > 0
    assert outs["cuda"] == outs["cpu"]
