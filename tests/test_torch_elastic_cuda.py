"""The elastic fleet on the card: the combined server (llama-small-test,
bf16, paged mixed lanes) mints one in-process lane and retires it.

- The minted lane's weights are the static lanes' tensors (the same
  ``data_ptr()`` leaf for leaf): it draws no weights of its own.
- It serves a stream through the gateway, launching the ragged read (#1)
  layers x its mixed ticks with no plain call.
- Retired through /admin/fleet (drain, migration, removal), it gives its
  device memory back: the retire frees at least its KV pool, a second
  mint and retire ends within one pool's bytes of the first's reading,
  and with cuBLAS's per-thread workspaces dropped the card holds what it
  held before the spawn, within one pool's bytes. (The decode thread's
  cuBLAS handle keeps a workspace, 32 MiB on an H100, which the next
  lane's thread reuses with the handle: a high-water mark, not a leak
  per lane.)

Every test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax:

    python -m pytest --noconftest -q tests/test_torch_elastic_cuda.py
"""

import gc
import http.client
import json

import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.ops import paged_attention
from tpu_engine_torch.serving.app import serve_combined, stop_combined
from tpu_engine_torch.utils.config import GatewayConfig, WorkerConfig


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the elastic fleet's lanes on the "
                    "card")
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


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@pytest.mark.cuda
def test_minted_lane_shares_weights_and_gives_memory_back(card):
    cfg = create_model("llama-small-test").config
    gw, workers, srv = serve_combined(
        model="llama-small-test", lanes=2, port=0, native_front=True,
        worker_config=WorkerConfig(gen_kv_block_size=16,
                                   gen_mixed_step=True,
                                   gen_prefill_chunk=64,
                                   gen_mixed_token_budget=64),
        gateway_config=GatewayConfig(port=0, autoscale=True,
                                     autoscale_interval_s=3600.0,
                                     autoscale_max_lanes=4))

    def memory() -> int:
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    def mint_and_retire(name: str) -> tuple:
        """(the pool's bytes, the reading with the lane, after it)."""
        res = gw._autoscaler.scale_up()
        assert res["status"] == "registered" and res["worker"] == name
        minted = workers[-1]
        static = [t.data_ptr() for t in _leaves(workers[0].engine.params)]
        assert static and [t.data_ptr() for t in _leaves(
            minted.engine.params)] == static
        pool = minted.generator._pool
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in (*pool.caches, *(pool.scales or ())))
        assert sorted(srv.ring_nodes()) == sorted(gw.worker_names())
        ragged = paged_attention.ragged_paged_attention
        ragged.launches = ragged.plain_calls = 0
        rid = next(r for r in (f"{name}-{i}" for i in range(400))
                   if gw._ring.get_node(r) == name)
        status, raw = _post(srv.port, "/generate/stream",
                            {"request_id": rid,
                             "prompt_tokens": list(range(3, 40)),
                             "max_new_tokens": 8})
        assert status == 200 and b'"done": true' in raw
        ticks = minted.generator.stats()["mixed"]["ticks"]
        assert ragged.plain_calls == 0
        assert ragged.launches == cfg.n_layers * ticks > 0
        with_lane = memory()
        status, raw = _post(srv.port, "/admin/fleet",
                            {"action": "remove", "worker": name})
        assert status == 200 and json.loads(raw)["status"] == "removed"
        assert minted not in workers and pool.caches is None
        assert sorted(srv.ring_nodes()) == sorted(gw.worker_names())
        return pool_bytes, with_lane, memory()

    try:
        torch._C._cuda_clearCublasWorkspaces()  # earlier tests' threads
        before = memory()
        pool_bytes, with_lane, after = mint_and_retire("worker_3")
        assert with_lane - after >= pool_bytes, (with_lane, after)
        _, _, again = mint_and_retire("worker_4")
        assert abs(again - after) < pool_bytes, (after, again, pool_bytes)
        torch._C._cuda_clearCublasWorkspaces()
        cleared = memory()
        assert abs(cleared - before) < pool_bytes, (before, cleared,
                                                     pool_bytes)
    finally:
        stop_combined(gw, workers, srv)
