"""The handoff on the card: two mixed schedulers of a small llama in f32
(TF32 off) on one set of weights, with the pool in the model's type (the
ragged kernel, #1) or int8 (its int8 twin, #4). A row submitted with
``handoff=True`` parks after its first token on A, ``export_row(
wait_prefill=True)`` snapshots it, and B's ``submit_import`` decodes the
rest: the stream equals the colocated run on A, B prefills nothing, the
kernel launches exactly layers x ticks of both lanes (no plain call), and
both pools end with no leaked block. Every test carries the ``cuda``
marker and skips where no CUDA device is present. This file imports no
jax, so the card's machine runs it without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_handoff_cuda.py
"""

import queue
import time

import pytest
import torch

from tpu_engine_torch.models.convert import init_params
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import kernels
from tpu_engine_torch.ops import paged_attention as tpa
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

POOLS = {"model": (tpa.ragged_paged_attention, ""),
         "int8": (tpa.quant_ragged_paged_attention, "int8")}
NEW = 24


@pytest.fixture
def f32_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ragged kernels have no CPU "
                    "mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _drain(q) -> list:
    out = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return out
        out.extend(item)


def _leak_free(gen) -> bool:
    st = gen.stats()
    kp = st["kv_pool"]
    return (st["active"] == 0
            and kp["blocks_free"] + kp["radix_nodes"] >= kp["blocks_total"])


@pytest.mark.cuda
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_parked_row_hands_off_on_the_card(f32_card, pool):
    kernel, quantize = POOLS[pool]
    spec = create_model("llama-small-test", max_seq=256)
    params = init_params(spec.config, seed=0, device=f32_card,
                         dtype="float32")
    kw = dict(params=params, dtype="float32", n_slots=4, max_seq=256,
              kv_block_size=16, prefill_chunk=16, mixed_step=True,
              mixed_token_budget=32, kv_quantize=quantize, device=f32_card)
    a = ContinuousGenerator(spec, **kw)
    b = ContinuousGenerator(spec, **kw)
    prompt = [(i * 37) % 250 + 1 for i in range(70)]
    try:
        # The control twice: the second resumes from A's radix, as the
        # handoff's prefill does.
        a.generate([prompt], max_new_tokens=NEW)
        control = a.generate([prompt], max_new_tokens=NEW)[0]
        kernels.reset_counts()
        ticks0 = a.stats()["mixed"]["ticks"]
        q = queue.Queue()
        a.submit(prompt, max_new_tokens=NEW, stream=q, tag="h",
                 handoff=True, handoff_park_s=60.0)
        snap = a.export_row("h", timeout_s=60.0, wait_prefill=True)
        assert snap["ok"] and len(snap["emitted"]) == 1
        got = _drain(q)
        q2 = queue.Queue()
        b.submit_import(snap, stream=q2, tag="h-b")
        got += _drain(q2)
        assert got == control
        st_b = b.stats()
        assert st_b["migration"]["imported_rows"] == 1
        assert st_b["kv_pool"]["prefilled_tokens"] == 0
        ticks = (a.stats()["mixed"]["ticks"] - ticks0
                 + st_b["mixed"]["ticks"])
        assert kernel.plain_calls == 0
        assert kernel.launches == spec.config.n_layers * ticks > 0
        end = time.monotonic() + 20
        while not (_leak_free(a) and _leak_free(b)):
            assert time.monotonic() < end, "blocks leaked"
            time.sleep(0.02)
    finally:
        a.stop()
        b.stop()
