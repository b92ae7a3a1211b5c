"""The tick-bounded profile on the card: a small llama's mixed lane (f32,
TF32 off) serves a burst, a capture of 4 scheduler ticks is taken while
its rows decode past one 512-key split (the merge kernel runs only when a
call has more than one split), and the Chrome trace holds the ragged
kernel's split and merge kernels by name, 4 ticks x layers launches of
each, with the tick spans and the ticks in stats() equal. The test carries the ``cuda`` marker and
skips where no CUDA device is present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_observability_cuda.py
"""

import json
import time

import pytest
import torch

from tpu_engine_torch.models.convert import init_params
from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.utils.tracing import SpanRecorder

TICKS = 4
PROMPT = 530  # keys past one split, so every decode call merges
SPLIT, MERGE = "ragged_split_kernel", "ragged_merge_kernel"


@pytest.fixture
def f32_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ragged kernel has no CPU "
                    "mode")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.cuda
def test_tick_bounded_capture_holds_the_ragged_kernels(f32_card, tmp_path):
    spec = create_model("llama-small-test", max_seq=1024)
    params = init_params(spec.config, seed=0, device=f32_card,
                         dtype="float32")
    gen = ContinuousGenerator(spec, params=params, dtype="float32",
                              n_slots=4, max_seq=1024, kv_block_size=16,
                              prefill_chunk=256, mixed_step=True,
                              mixed_token_budget=256, device=f32_card)
    gen.tracer = SpanRecorder(4096)
    layers = spec.config.n_layers
    try:
        futs = [gen.submit([(i * 37 + k) % 250 + 1 for k in range(PROMPT)],
                           max_new_tokens=200) for i in range(4)]
        end = time.monotonic() + 120
        while gen.stats()["mixed"]["prefill_tokens"] < 4 * PROMPT:
            assert time.monotonic() < end, "the prompts did not prefill"
            time.sleep(0.01)
        res = gen.start_profile(str(tmp_path), TICKS)
        assert res["ok"] and res["ticks"] == TICKS
        for f in futs:
            f.result(timeout=300)
        last = gen.profile_status()["last_result"]
        assert last["ok"] and last["device_events"] > 0
        with open(last["trace_file"]) as f:
            events = json.load(f)["traceEvents"]
        names = [e["name"] for e in events if e.get("cat") == "kernel"]
        assert sum(SPLIT in n for n in names) == TICKS * layers
        assert sum(MERGE in n for n in names) == TICKS * layers
        ticks = gen.stats()["mixed"]["ticks"]
        spans = [s for s in gen.tracer.snapshot() if s["op"] == "mixed_step"]
        assert len(spans) == ticks
    finally:
        gen.stop()
