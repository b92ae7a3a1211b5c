"""Mesh-sharded serving of the port (``tpu_engine_torch``: ``parallel.mesh``'s
``Mesh`` and ``place``, ``training.train.shard_params_tp``, the engine's
``mesh``, ``serving.app``'s ``parse_mesh_spec``, ``_mesh_engine`` and
``serve_combined(mesh=...)``) against the JAX package's
``tests/test_mesh_serving.py`` contracts, on the CPU (every port rank on
``cpu``, JAX on its 8 virtual devices):

- ``parse_mesh_spec`` gives JAX's axes, and refuses a mesh larger than the
  cards with JAX's message;
- ``place(params, shard_params_tp(params, mesh))`` gives each rank the
  ``addressable_shards`` JAX's ``jax.device_put(params,
  shard_params_tp(params, mesh))`` gives its device, in mesh order, for
  mlp, resnet50 and llama-small-test; a quantized tree and an int8 engine
  with TP shardings refuse with JAX's messages;
- the mesh engine at data=8 and model=2,data=4 (mlp) and model=2,data=2
  (llama-small-test logits) answers JAX's ``_mesh_engine`` within 1e-5 in
  f32 on the same weights, with JAX's buckets and ``stats()["mesh"]``;
  each of its rows is bit-identical to the port's single-device engine
  run on that data rank's slice (the same rows a forward: a CPU product's
  bits depend on its row count, so the whole bucket on one device may
  differ from the slices in the last bit, within 1e-5 here);
- ``serve_combined(mesh="model=2,data=4")`` over HTTP: one lane
  ``worker_1``, the reference wire schema, a cache hit and ``/health``,
  like JAX's ``mesh_stack``; behind the C++ front the repeat is answered
  in C++;
- the mesh lane's modules import no jax.
"""

import ast
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops.quant import quantize_params as jquantize
from tpu_engine.parallel.mesh import create_mesh as jcreate_mesh
from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
from tpu_engine.serving import app as japp
from tpu_engine.training import train as jtrain
from tpu_engine.utils.config import WorkerConfig as JaxWorkerConfig
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops.quant import quantize_params
from tpu_engine_torch.parallel.mesh import flatten_tree, place
from tpu_engine_torch.runtime.engine import InferenceEngine
from tpu_engine_torch.serving import app as tapp
from tpu_engine_torch.training.train import shard_params_tp
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parents[1]
RESNET = dict(num_classes=16)


def _jax_mesh(spec: str):
    """JAX's mesh of ``spec`` over the first devices it needs (JAX's
    ``parse_mesh_spec`` takes every device, which must be 8)."""
    axes = [(n, int(v)) for n, _, v in (p.partition("=")
                                        for p in spec.split(","))]
    if "data" not in dict(axes):
        axes.append(("data", 1))
    n = int(np.prod([v for _, v in axes]))
    return jcreate_mesh(shape=tuple(v for _, v in axes),
                        axis_names=tuple(k for k, _ in axes),
                        devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def trees():
    """name -> (JAX params, the port's f32 tree on the CPU), drawn once."""
    cache = {}

    def get(name):
        if name not in cache:
            kw = RESNET if name == "resnet50" else {}
            spec = jcreate(name, **kw)
            if name == "resnet50":
                # The init's shapes, filled from numpy (its compiled init
                # is slow on the CPU).
                rng = np.random.default_rng(0)
                shapes = jax.eval_shape(spec.init, jax.random.PRNGKey(0))
                jp = jax.tree.map(lambda sd: rng.standard_normal(
                    sd.shape).astype(np.float32), shapes)
            else:
                jp = jax.tree.map(np.asarray,
                                  spec.init(jax.random.PRNGKey(0)))
            cfg = getattr(tcreate(name, **kw), "config", None)
            cache[name] = (jp, convert.params_from_jax(
                jp, cfg if hasattr(cfg, "n_layers") else None, "cpu",
                "float32"))
        return cache[name]
    return get


# -- the mesh ------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["data=8", "model=2,data=4", "model=8"])
def test_parse_mesh_spec_axes_match_jax(spec):
    want = japp.parse_mesh_spec(spec)
    got = tapp.parse_mesh_spec(spec, device="cpu")
    assert list(got.shape.items()) == list(want.shape.items())
    assert got.size == want.size == 8
    assert got.devices == (torch.device("cpu"),) * 8


def test_mesh_order_and_coords_are_jax_row_major():
    """Rank r sits where JAX's mesh puts device r: (model, data) row
    major."""
    want = _jax_mesh("model=2,data=4")
    got = tapp.parse_mesh_spec("model=2,data=4", device="cpu")
    order = list(want.devices.flat)
    for r in range(got.size):
        idx = np.argwhere(want.devices == order[r])[0]
        assert got.coords(r) == dict(zip(want.axis_names, map(int, idx)))
        assert got.rank(**got.coords(r)) == r
    assert got.data_ranks() == [0, 1, 2, 3]


def test_data_sharding_and_single_device_mesh_match_jax():
    """A batch placed by ``data_sharding`` (and whole by ``replicated``)
    holds on each rank what JAX's placement holds on its device."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_engine.parallel import mesh as jmesh_mod
    from tpu_engine_torch.parallel import mesh as tmesh_mod

    jm = _jax_mesh("model=2,data=4")
    tm = tapp.parse_mesh_spec("model=2,data=4", device="cpu")
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    order = list(jm.devices.flat)
    for jshard, tshard in (
            (jmesh_mod.data_sharding(jm, "data", 2),
             tmesh_mod.data_sharding(tm, "data")),
            (NamedSharding(jm, P()), tmesh_mod.replicated(tm))):
        shards = sorted(jax.device_put(x, jshard).addressable_shards,
                        key=lambda s: order.index(s.device))
        placed = place(torch.from_numpy(x), tshard)
        for r in range(tm.size):
            np.testing.assert_array_equal(placed.ranks[r][0].numpy(),
                                          np.asarray(shards[r].data))
    one = tmesh_mod.single_device_mesh("cpu")
    want = jmesh_mod.single_device_mesh()
    assert list(one.shape.items()) == list(want.shape.items())
    assert one.size == want.size == 1


def test_mesh_larger_than_the_cards_refuses_with_jax_message():
    """No --device: the ranks are the CUDA devices, none here; JAX's
    ``create_mesh`` message, and no fall back to the CPU."""
    with pytest.raises(ValueError) as want:
        jcreate_mesh(shape=(2,), devices=[])
    with pytest.raises(ValueError) as got:
        tapp.parse_mesh_spec("data=2")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs 2 devices, have 0"):
        tapp.serve_combined(model="mlp", port=0, mesh="data=2",
                            worker_config=WorkerConfig(dtype="float32"),
                            native_front=False)


# -- placement ----------------------------------------------------------------

def _jax_shards(jp, mesh):
    """path -> the leaf's shards (numpy) on each device in mesh order."""
    placed = jax.device_put(jp, jtrain.shard_params_tp(jp, mesh, "model"))
    order = list(mesh.devices.flat)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(placed)[0]:
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = [np.asarray(s.data) for s in sorted(
            leaf.addressable_shards, key=lambda s: order.index(s.device))]
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _hwio(t: torch.Tensor) -> np.ndarray:
    """A port leaf in JAX's layout (conv kernels OIHW -> HWIO)."""
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


@pytest.mark.parametrize("name,spec", [
    ("mlp", "model=2,data=4"), ("mlp", "model=4,data=2"),
    ("resnet50", "model=2"), ("llama-small-test", "model=2,data=2"),
])
def test_shard_params_tp_rank_trees_equal_jax_shards(trees, name, spec):
    jp, tp = trees(name)
    want = _jax_shards(jp, _jax_mesh(spec))
    mesh = tapp.parse_mesh_spec(spec, device="cpu")
    placed = place(tp, shard_params_tp(tp, mesh))
    ranks = [dict(_named(placed.local(r))) for r in range(mesh.size)]
    for path, shards in want.items():
        parts = path.split("/")
        assert len(shards) == mesh.size
        for r in range(mesh.size):
            if parts[0] == "blocks":
                # JAX's stacked (L, ...) leaf against the port's layers.
                got = np.stack([_hwio(ranks[r]["/".join(
                    ["blocks", str(li)] + parts[1:])])
                    for li in range(shards[r].shape[0])])
            else:
                got = _hwio(ranks[r][path])
            np.testing.assert_array_equal(got, shards[r], err_msg=path)
    assert any(s.axis == "model" for s in placed.shardings)
    # The whole tree gathers back, bit for bit, on every rank.
    for r in range(mesh.size):
        for a, b in zip(flatten_tree(placed.gathered(r)), flatten_tree(tp)):
            assert torch.equal(a, b)


def test_quantized_tree_and_int8_tp_engine_refuse_like_jax(trees):
    jp, tp = trees("mlp")
    with pytest.raises(RuntimeError) as want:
        jtrain.shard_params_tp(jquantize(jp), _jax_mesh("model=2,data=4"))
    mesh = tapp.parse_mesh_spec("model=2,data=4", device="cpu")
    with pytest.raises(RuntimeError) as got:
        shard_params_tp(quantize_params(tp), mesh)
    assert str(got.value) == str(want.value)
    jmesh = _jax_mesh("model=2,data=4")
    with pytest.raises(ValueError) as want:
        JaxEngine("mlp", params=jp, dtype="float32", quantize="int8",
                  mesh=jmesh,
                  param_shardings=jtrain.shard_params_tp(jp, jmesh))
    with pytest.raises(ValueError) as got:
        InferenceEngine("mlp", params=tp, dtype="float32", quantize="int8",
                        mesh=mesh, param_shardings=shard_params_tp(tp, mesh))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="either mesh or device"):
        InferenceEngine("mlp", params=tp, mesh=mesh, device="cpu")


# -- the mesh engine -------------------------------------------------------------

def _inputs(name, n):
    rng = np.random.default_rng(1)
    if name == "mlp":
        return [rng.standard_normal(16).astype(np.float32) for _ in range(n)]
    return [rng.integers(1, 200, int(rng.integers(3, 14))).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("name,spec,n", [
    ("mlp", "data=8", 11), ("mlp", "model=2,data=4", 5),
    ("llama-small-test", "model=2,data=2", 5),
])
def test_mesh_engine_matches_jax_and_the_single_device_engine(
        trees, name, spec, n):
    jp, tp = trees(name)
    buckets = (4, 8)
    jmesh = _jax_mesh(spec)
    jeng = japp._mesh_engine(name, JaxWorkerConfig(
        model=name, dtype="float32", batch_buckets=buckets), jmesh,
        params=jax.tree.map(np.asarray, jp))
    mesh = tapp.parse_mesh_spec(spec, device="cpu")
    eng = tapp._mesh_engine(name, WorkerConfig(
        model=name, dtype="float32", batch_buckets=buckets), mesh,
        params=tp)
    assert eng.buckets == jeng.buckets
    assert eng.stats()["mesh"] == jeng.stats()["mesh"]
    split = [s.axis for s in eng._placed.shardings]
    assert ("model" in split) == ("model" in spec)
    inputs = _inputs(name, n)
    got = eng.batch_predict(inputs)
    want = jeng.batch_predict(inputs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    whole = InferenceEngine(name, params=tp, dtype="float32",
                            batch_buckets=eng.buckets, device="cpu")
    for g, w in zip(got, whole.batch_predict(inputs)):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    # Each data rank's rows: the single-device engine on that slice.
    d = mesh.shape["data"]
    top = eng.buckets[-1]
    for c0 in range(0, n, top):
        chunk = inputs[c0:c0 + top]
        rows = next(b for b in eng.buckets if b >= len(chunk)) // d
        one = InferenceEngine(name, params=tp, dtype="float32",
                              batch_buckets=(rows,), device="cpu")
        for k in range(0, len(chunk), rows):
            for g, w in zip(got[c0 + k:c0 + k + rows],
                            one.batch_predict(chunk[k:k + rows])):
                np.testing.assert_array_equal(g, w)


def test_mesh_engine_reload_replaces_every_rank(trees):
    _, tp = trees("mlp")
    mesh = tapp.parse_mesh_spec("model=2,data=4", device="cpu")
    eng = tapp._mesh_engine("mlp", WorkerConfig(
        model="mlp", dtype="float32", batch_buckets=(4, 8)), mesh, params=tp)
    new = {k: {n: t * 2 for n, t in v.items()} for k, v in tp.items()}
    eng.set_params(new)
    one = InferenceEngine("mlp", params=new, dtype="float32",
                          batch_buckets=(1,), device="cpu")
    x = _inputs("mlp", 1)
    np.testing.assert_array_equal(eng.predict(x[0]), one.predict(x[0]))


# -- mesh serving over HTTP -------------------------------------------------------

def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", json.dumps(payload).encode(),
        {"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


def _get(port, path):
    return json.loads(urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30).read())


@pytest.fixture(scope="module")
def jax_mesh_stack():
    cfg = JaxWorkerConfig(model="mlp", dtype="float32", batch_buckets=(4, 8))
    gw, workers, server = japp.serve_combined(
        model="mlp", port=0, worker_config=cfg, mesh="model=2,data=4",
        native_front=False)
    try:
        yield server.port
    finally:
        server.stop()
        for w in workers:
            w.stop()


@pytest.mark.parametrize("native_front", [False, True],
                         ids=["python-front", "native-front"])
def test_mesh_serving_http_like_jax(jax_mesh_stack, native_front):
    cfg = WorkerConfig(model="mlp", dtype="float32", batch_buckets=(4, 8),
                       device="cpu")
    gw, workers, server = tapp.serve_combined(
        model="mlp", port=0, worker_config=cfg, mesh="model=2,data=4",
        native_front=native_front)
    try:
        assert [w.node_id for w in workers] == ["worker_1"]
        assert workers[0].engine.stats()["mesh"] == {
            "axes": {"model": 2, "data": 4}, "n_devices": 8}
        body = {"request_id": "req_1", "input_data": [1.0, 2.0, 3.0]}
        resp = _post(server.port, "/infer", body)
        want = _post(jax_mesh_stack, "/infer", body)
        assert set(resp) == set(want) == {
            "request_id", "output_data", "node_id", "cached",
            "inference_time_us"}
        assert resp["node_id"] == want["node_id"] == "worker_1"
        assert len(resp["output_data"]) == len(want["output_data"])
        assert np.isfinite(resp["output_data"]).all()
        again = _post(server.port, "/infer",
                      {"request_id": "req_2", "input_data": [1.0, 2.0, 3.0]})
        assert again["cached"] is True
        assert again["output_data"] == resp["output_data"]
        health = _get(server.port, "/health")
        jhealth = _get(jax_mesh_stack, "/health")
        assert health["healthy"] is jhealth["healthy"] is True
        assert health["total_requests"] >= 1
        if native_front:
            # The repeat never reached Python: the gateway counted one.
            assert _get(server.port, "/stats")["total_requests"] == 1
            assert health["total_requests"] == 2
    finally:
        tapp.stop_combined(gw, workers, server)


def test_mesh_serving_is_single_model_like_jax():
    with pytest.raises(ValueError) as want:
        japp.serve_combined(model="mlp,resnet50", port=0,
                            mesh="model=2,data=4", native_front=False)
    with pytest.raises(ValueError) as got:
        tapp.serve_combined(model="mlp,resnet50", port=0,
                            mesh="model=2,data=4", native_front=False,
                            worker_config=WorkerConfig(device="cpu"))
    assert str(got.value) == str(want.value)


# -- no jax ------------------------------------------------------------------------

MESH_SOURCES = ("parallel/mesh.py", "training/train.py", "runtime/engine.py",
                "serving/app.py", "serving/cli.py", "serving/worker.py")


@pytest.mark.parametrize("rel", MESH_SOURCES)
def test_mesh_sources_import_no_jax(rel):
    tree = ast.parse((REPO / "tpu_engine_torch" / rel).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert [n for n in names if n.split(".")[0] in
            ("jax", "jaxlib", "tpu_engine")] == []


def test_mesh_lane_imports_no_jax():
    """A mesh lane serving /infer in a fresh process: no jax and no
    tpu_engine module is loaded."""
    code = (
        "import json, sys\n"
        "from tpu_engine_torch.serving import app\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        "gw, ws, srv = app.serve_combined(model='mlp', port=0,"
        " mesh='model=2,data=2', native_front=False,"
        " worker_config=WorkerConfig(device='cpu', dtype='float32'))\n"
        "out = ws[0].handle_infer({'request_id': 'a',"
        " 'input_data': [1.0, 2.0]})\n"
        "app.stop_combined(gw, ws, srv)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'n': len(out['output_data']), 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "n": 16, "bad": []}
