"""Hot weight reload in the port (``WorkerNode.reload_weights``,
``/admin/reload``): the counterparts of ``tests/test_reload.py``'s cases
(the quantized and combined-server ones stay refused with their
features). Checkpoints are the port's own format (``utils.checkpoint``).
All on the CPU, in f32.

Tolerances: a reloaded lane against a fresh lane on the same checkpoint:
exact (same weights, same forward, same batch shapes); post-settle
answers 1e-5 relative.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.training.train import tree_map
from tpu_engine_torch.utils.checkpoint import save_params
from tpu_engine_torch.utils.config import WorkerConfig

NAME = "gpt2-small-test"


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_reload")
    spec = create_model(NAME)
    p1 = save_params(str(d / "w1"), spec.init(1, device="cpu",
                                               dtype="float32"))
    p2 = save_params(str(d / "w2"), spec.init(2, device="cpu",
                                               dtype="float32"))
    other = create_model(NAME, n_layers=1, d_model=32, n_heads=2, d_ff=64)
    p_bad = save_params(str(d / "bad"), other.init(3, device="cpu",
                                                    dtype="float32"))
    bf16 = tree_map(lambda t: t.to(torch.bfloat16),
                    spec.init(5, device="cpu", dtype="float32"))
    p_bf16 = save_params(str(d / "bf16"), bf16)
    return p1, p2, p_bad, p_bf16


def _worker(path, **kw):
    return WorkerNode(WorkerConfig(node_id="w_reload", model=NAME,
                                   dtype="float32", device="cpu",
                                   model_path=path, **kw))


LANES = [{}, dict(gen_kv_block_size=16, gen_mixed_step=True,
                  gen_prefill_chunk=16)]


@pytest.mark.parametrize("lane", LANES, ids=["dense", "mixed"])
def test_reload_changes_outputs_and_clears_caches(ckpts, lane):
    """After the reload /infer answers the new weights (not the cached old
    answer), and a greedy /generate of a prompt served before the reload
    (whose prefix the lane's prefix cache or radix tree holds) equals a
    fresh lane's on the new checkpoint."""
    p1, p2, _, _ = ckpts
    w = _worker(p1, **lane)
    try:
        req = {"request_id": "r1", "input_data": [5.0, 9.0]}
        gen = {"prompt_tokens": [5, 9, 3, 7] * 5, "max_new_tokens": 6}
        before = w.handle_infer(dict(req))["output_data"]
        assert w.handle_infer(dict(req))["cached"]
        gen_before = w.handle_generate({"request_id": "g1", **gen})["tokens"]
        out = w.reload_weights(p2)
        assert out == {"ok": True, "node_id": "w_reload", "model_path": p2}
        assert w.cache.size() == 0
        after = w.handle_infer(dict(req))
        assert after["output_data"] != before and not after["cached"]
        gen_after = w.handle_generate({"request_id": "g2", **gen})["tokens"]
        assert gen_after != gen_before
    finally:
        w.stop()
    fresh = _worker(p2, **lane)
    try:
        assert fresh.handle_infer(dict(req))["output_data"] == \
            after["output_data"]
        assert fresh.handle_generate({"request_id": "g3",
                                      **gen})["tokens"] == gen_after
    finally:
        fresh.stop()


def test_reload_rejects_mismatched_architecture(ckpts):
    p1, _, p_bad, _ = ckpts
    w = _worker(p1)
    try:
        req = {"request_id": "m1", "input_data": [4.0, 2.0]}
        before = w.handle_infer(dict(req))["output_data"]
        with pytest.raises(ValueError, match="reload rejected"):
            w.reload_weights(p_bad)
        with pytest.raises(ValueError, match="no loadable weights"):
            w.reload_weights(p_bad + "-missing")
        again = w.handle_infer({"request_id": "m2",
                                "input_data": [4.0, 2.0]})
        assert again["output_data"] == before
    finally:
        w.stop()


def test_reload_rejects_dtype_drift(ckpts):
    """A checkpoint whose leaves restore in another dtype (here bf16
    embeddings and biases) is refused; the lane keeps serving."""
    p1, _, _, p_bf16 = ckpts
    w = _worker(p1)
    try:
        with pytest.raises(ValueError, match="dtype"):
            w.reload_weights(p_bf16)
        assert w.handle_infer({"request_id": "d1",
                               "input_data": [1.0]})["output_data"]
    finally:
        w.stop()


def test_reload_over_http(ckpts):
    p1, p2, p_bad, _ = ckpts
    w, s = serve_worker(WorkerConfig(port=0, node_id="w_http", model=NAME,
                                     dtype="float32", device="cpu",
                                     model_path=p1))

    def post(path, body):
        return json.loads(urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{s.port}{path}",
            data=json.dumps(body).encode()), timeout=60).read())

    try:
        req = {"request_id": "h1", "input_data": [3.0, 1.0]}
        before = post("/infer", req)["output_data"]
        assert post("/admin/reload", {"model_path": p2}) == {
            "ok": True, "node_id": "w_http", "model_path": p2}
        after = post("/infer", req)
        assert after["output_data"] != before and not after["cached"]
        with pytest.raises(urllib.error.HTTPError) as err:
            post("/admin/reload", {"model_path": p_bad})
        assert err.value.code == 400
        assert post("/infer", req)["output_data"] == after["output_data"]
    finally:
        s.stop()
        w.stop()


@pytest.mark.parametrize("unified", [True, False])
def test_reload_under_concurrent_load(ckpts, unified):
    """Reload races live /infer traffic: no request fails, and once the
    swap settles identical inputs answer the new weights (a cached answer
    equals a recomputed one: no old-weight result entered the cache)."""
    p1, p2, _, _ = ckpts
    w = _worker(p1, unified_stateless=unified)
    fresh = _worker(p2)
    try:
        errors, stop = [], threading.Event()

        def hammer(tid):
            i = 0
            while not stop.is_set():
                try:
                    w.handle_infer({"request_id": f"t{tid}_{i}",
                                    "input_data": [float(i % 7), 2.0]})
                except Exception as exc:  # noqa: BLE001 - recorded
                    errors.append(exc)
                    return
                i += 1

        threads = [threading.Thread(target=hammer, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        w.reload_weights(p2)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in threads)
        for v in range(7):
            req = {"request_id": f"post{v}", "input_data": [float(v), 2.0]}
            got = w.handle_infer(dict(req))["output_data"]
            want = fresh.handle_infer(dict(req))["output_data"]
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    finally:
        w.stop()
        fresh.stop()
