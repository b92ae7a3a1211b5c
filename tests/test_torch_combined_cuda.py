"""The combined server (``serving.app.serve_combined``) on the card:

- two mlp lanes (bf16) behind the C++ front: repeats of one input are
  answered in C++ (the lanes' /health counts them: requests and hits,
  beside the gateway's count of the Python path's), and every hit's
  output_data is byte for byte its lane's miss fragment;
- a mixed decoder lane (llama-small-test, bf16, paged, one lane) behind the
  C++ front: streams and a /score row complete, and the ragged read (#1)
  launched exactly layers x the lane's mixed ticks, the flash forward (#5)
  layers x its one-shot dispatches, with no plain call.

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_combined_cuda.py
"""

import http.client
import json

import numpy as np
import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import flash, paged_attention
from tpu_engine_torch.serving.app import serve_combined, stop_combined
from tpu_engine_torch.utils.config import WorkerConfig


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the combined server's lanes on "
                    "the card")
    return torch.device("cuda")


def _post(port: int, path: str, body: dict):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _get(port: int, path: str) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path)
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _fragment(raw: bytes) -> bytes:
    a = raw.index(b'"output_data": ') + len(b'"output_data": ')
    return raw[a:raw.index(b', "node_id"', a)]


@pytest.mark.cuda
def test_cpp_hits_on_two_card_lanes(card):
    gw, workers, srv = serve_combined(
        model="mlp", lanes=2, port=0, native_front=True,
        worker_config=WorkerConfig(batch_buckets=(1, 2, 4, 8),
                                   max_batch_size=8))
    try:
        assert [str(w.engine.device) for w in workers] == ["cuda:0"] * 2
        rng = np.random.default_rng(0)
        inputs = [rng.standard_normal(784).tolist() for _ in range(3)]
        frags, cached = {}, 0
        for i in range(30):
            status, raw = _post(srv.port, "/infer",
                                {"request_id": f"c{i}x{i * 7919}",
                                 "input_data": inputs[i % 3]})
            assert status == 200, raw
            ans = json.loads(raw)
            assert np.isfinite(ans["output_data"]).all()
            key = (i % 3, ans["node_id"])
            assert frags.setdefault(key, _fragment(raw)) == _fragment(raw)
            cached += ans["cached"]
        health, stats = _get(srv.port, "/health"), _get(srv.port, "/stats")
        cpp = health["total_requests"] - stats["total_requests"]
        assert health["total_requests"] == 30
        assert health["cache_hits"] == cached
        assert cpp >= 30 - len(frags) and cpp > 0
        assert cpp == sum(srv.lane_counters(w.node_id)[1] for w in workers)
    finally:
        stop_combined(gw, workers, srv)


@pytest.mark.cuda
def test_mixed_decoder_lane_launches(card):
    cfg = create_model("llama-small-test").config
    gw, workers, srv = serve_combined(
        model="llama-small-test", lanes=1, port=0, native_front=True,
        worker_config=WorkerConfig(gen_kv_block_size=16,
                                   gen_mixed_step=True,
                                   gen_prefill_chunk=64,
                                   gen_mixed_token_budget=64))
    try:
        ragged = paged_attention.ragged_paged_attention
        fwd = flash.flash_attention_fwd
        for fn in (ragged, fwd):
            fn.launches = fn.plain_calls = 0
        rng = np.random.default_rng(1)
        for i, n in enumerate((20, 90, 7)):
            prompt = [int(t) for t in rng.integers(1, cfg.vocab, n)]
            status, raw = _post(srv.port, "/generate/stream",
                                {"request_id": f"s{i}",
                                 "prompt_tokens": prompt,
                                 "max_new_tokens": 6})
            assert status == 200 and b'"done": true' in raw
        status, raw = _post(srv.port, "/score", {
            "request_id": "sc", "prompt_tokens": [3, 4, 5],
            "completion_tokens": [6, 7]})
        assert status == 200 and len(json.loads(raw)["logprobs"]) == 2
        gen = _get(srv.port, "/health/worker_1")["generator"]
        assert ragged.plain_calls == fwd.plain_calls == 0
        assert ragged.launches == cfg.n_layers * gen["mixed"]["ticks"] > 0
        assert fwd.launches == (cfg.n_layers
                                * gen["stateless"]["dispatches"]) > 0
    finally:
        stop_combined(gw, workers, srv)
