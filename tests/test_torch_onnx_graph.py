"""The port's ONNX executor (``tpu_engine_torch.models.onnx_graph``) against
the JAX package's (``tpu_engine.models.onnx_graph``) on graphs written by
``tests/onnx_writer.py``: the residual CNN of ``tests/test_onnx_graph.py``,
the mini-BERT encoder and the mini-GPT decoder of
``tests/test_onnx_transformer.py``, and small graphs of the other ops.
Then the port's worker and the ``worker_node`` argv serve a ``.onnx``
file end to end. All on the CPU.

Tolerances: f32 1e-5 absolute on outputs of magnitude <= 3 (the same f32
ops, summed in another order); bf16 1e-5 as well, since both executors
round the same operands to bf16 and sum in f32.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import onnx_writer as ow
from tests.test_onnx_graph import TorchGolden, _export_onnx
from tests.test_onnx_transformer import (
    SEQ,
    VOCAB,
    _export_minibert,
    _export_minigpt,
    _weights,
)
from tpu_engine.models import onnx_graph as jg
from tpu_engine_torch.models import onnx_graph as pg
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5


def _ids(seed: int) -> np.ndarray:
    ids = np.random.default_rng(seed).integers(1, VOCAB, (4, SEQ)).astype(
        np.float32)
    ids[1, 10:] = 0.0
    ids[3, :] = 0.0  # an all-pad row
    return ids


def _write(path: Path, nodes, inits, in_dims, out_dims) -> str:
    path.write_bytes(ow.model(nodes, inits, ow.value_info("input", in_dims),
                              ow.value_info("output", out_dims)))
    return str(path)


def _attr_string(name: str, value: str) -> bytes:
    """A STRING AttributeProto (type 3, field 4)."""
    return ow._attr(name, 3, ow._ld(4, value.encode()))


def _ops_graph(path: Path) -> str:
    """AveragePool, Sigmoid, Sub, Clip, Mul, Div, Transpose, Reshape,
    Concat, MatMul, Gelu, Tanh, Neg, Abs, Exp, Log, Sqrt, Pow, Max, Min,
    ReduceSum, Flatten, Softmax: tests/test_onnx_graph.py's extended
    subset and the other unaries."""
    w = np.random.default_rng(2).standard_normal((96, 10)).astype(np.float32)
    nodes = [
        ow.node("AveragePool", ["input"], ["a"],
                [ow.attr_ints("kernel_shape", [2, 2]),
                 ow.attr_ints("strides", [2, 2])]),
        ow.node("Sigmoid", ["a"], ["s"]),
        ow.node("Sub", ["s", "q"], ["sub"]),
        ow.node("Clip", ["sub"], ["c"],
                [ow.attr_float("min", 0.0), ow.attr_float("max", 0.9)]),
        ow.node("Mul", ["c", "a"], ["m"]),
        ow.node("Div", ["m", "h"], ["d"]),
        ow.node("Transpose", ["d"], ["t"],
                [ow.attr_ints("perm", [0, 2, 3, 1])]),
        ow.node("Reshape", ["t", "flatshape"], ["flat"]),
        ow.node("Concat", ["flat", "flat"], ["cat"], [ow.attr_int("axis", 1)]),
        ow.node("MatMul", ["cat", "w"], ["mm"]),
        ow.node("Gelu", ["mm"], ["g"]),
        ow.node("Tanh", ["g"], ["th"]),
        ow.node("Neg", ["th"], ["ng"]),
        ow.node("Abs", ["ng"], ["ab"]),
        ow.node("Exp", ["ab"], ["ex"]),
        ow.node("Log", ["ex"], ["lg"]),
        ow.node("Sqrt", ["ex"], ["sq"]),
        ow.node("Pow", ["sq", "h"], ["pw"]),
        ow.node("Max", ["pw", "lg", "mm"], ["mx"]),
        ow.node("Min", ["mx", "h"], ["mn"]),
        ow.node("ReduceSum", ["mn"], ["rs"],
                [ow.attr_ints("axes", [1]), ow.attr_int("keepdims", 1)]),
        ow.node("Add", ["mn", "rs"], ["ad"]),
        ow.node("Flatten", ["ad"], ["fl"], [ow.attr_int("axis", -1)]),
        ow.node("Softmax", ["fl"], ["output"], [ow.attr_int("axis", -1)]),
    ]
    inits = {"q": np.full((1,), 0.25, np.float32),
             "h": np.full((1,), 2.0, np.float32),
             "flatshape": np.asarray([0, -1], np.int64), "w": w}
    return _write(path, nodes, inits, ["N", 3, 8, 8], ["N", 10])


def _shape_ops_graph(path: Path) -> str:
    """Shape, Slice of a Shape into a Reshape (static), Gather of a Shape,
    Unsqueeze, Concat, Reshape, Slice with a step, Split by count, Squeeze, Expand, ConstantOfShape, Range, Trilu,
    Where, Cast, Equal, Greater, Less, ReduceMean, Constant, Identity,
    MaxPool with padding, Conv with SAME_UPPER and groups, BatchNorm,
    GlobalAveragePool, Gemm with alpha and beta."""
    rng = np.random.default_rng(5)
    nodes = [
        ow.node("Conv", ["input", "cw", "cb"], ["cv"],
                [ow.attr_ints("strides", [2, 2]), ow.attr_int("group", 2),
                 ow.attr_ints("kernel_shape", [3, 3]),
                 _attr_string("auto_pad", "SAME_UPPER")]),
        ow.node("BatchNormalization", ["cv", "g", "b", "mu", "var"], ["bn"],
                [ow.attr_float("epsilon", 1e-3)]),
        ow.node("MaxPool", ["bn"], ["mp"],
                [ow.attr_ints("kernel_shape", [3, 3]),
                 ow.attr_ints("pads", [1, 1, 1, 1])]),
        ow.node("Shape", ["mp"], ["shp"]),
        ow.node("Slice", ["shp", "ax0", "four", "ax0"], ["shp2"]),
        ow.node("Reshape", ["mp", "flatshape"], ["flat0"]),
        ow.node("Reshape", ["flat0", "shp2"], ["mp2"]),
        ow.node("Reshape", ["mp2", "flatshape"], ["flat"]),
        ow.node("Gather", ["shp", "i0"], ["n"], [ow.attr_int("axis", 0)]),
        ow.node("Cast", ["n"], ["nf"], [ow.attr_int("to", 1)]),
        ow.node("Slice", ["flat", "s0", "s1", "s_ax", "s_st"], ["sl"]),
        ow.node("Split", ["sl"], ["p", "r"], [ow.attr_int("axis", 1)]),
        ow.node("Identity", ["p"], ["pid"]),
        ow.node("Constant", [], ["cst"],
                [ow.attr_tensor("value", np.asarray([0.5], np.float32))]),
        ow.node("Greater", ["pid", "cst"], ["gt"]),
        ow.node("Less", ["r", "cst"], ["lt"]),
        ow.node("Equal", ["gt", "lt"], ["eq"]),
        ow.node("Where", ["eq", "pid", "r"], ["wh"]),
        ow.node("Cast", ["gt"], ["gtf"], [ow.attr_int("to", 1)]),
        ow.node("Add", ["wh", "gtf"], ["wa"]),
        ow.node("ReduceMean", ["wa"], ["rm"],
                [ow.attr_ints("axes", [1]), ow.attr_int("keepdims", 1)]),
        ow.node("Range", ["r0", "r4", "r1"], ["rg"]),
        ow.node("Cast", ["rg"], ["rgf"], [ow.attr_int("to", 1)]),
        ow.node("Unsqueeze", ["rgf", "ax0"], ["rg2"]),
        ow.node("Expand", ["rg2", "eshape"], ["ex"]),
        ow.node("Trilu", ["ex"], ["tri"], [ow.attr_int("upper", 0)]),
        ow.node("ConstantOfShape", ["cshape"], ["ones"],
                [ow.attr_tensor("value", np.asarray([1.0], np.float32))]),
        ow.node("Add", ["tri", "ones"], ["t2"]),
        ow.node("ReduceSum", ["t2"], ["t3"],
                [ow.attr_ints("axes", [0]), ow.attr_int("keepdims", 1)]),
        ow.node("Squeeze", ["t3", "ax0"], ["t4"]),
        ow.node("Mul", ["rm", "t4"], ["mix0"]),
        ow.node("Mul", ["mix0", "nf"], ["mix"]),
        ow.node("GlobalAveragePool", ["bn"], ["gap"]),
        ow.node("Flatten", ["gap"], ["gf"]),
        ow.node("Concat", ["mix", "gf"], ["feat"], [ow.attr_int("axis", 1)]),
        ow.node("Gemm", ["feat", "gw", "gb"], ["output"],
                [ow.attr_float("alpha", 0.5), ow.attr_float("beta", 2.0),
                 ow.attr_int("transB", 1)]),
    ]
    inits = {
        "cw": rng.standard_normal((4, 2, 3, 3)).astype(np.float32) * 0.3,
        "cb": rng.standard_normal((4,)).astype(np.float32) * 0.1,
        "g": (1 + 0.1 * rng.standard_normal(4)).astype(np.float32),
        "b": (0.1 * rng.standard_normal(4)).astype(np.float32),
        "mu": (0.1 * rng.standard_normal(4)).astype(np.float32),
        "var": (1 + 0.1 * rng.random(4)).astype(np.float32),
        "i0": np.asarray(0, np.int64), "ax0": np.asarray([0], np.int64),
        "flatshape": np.asarray([0, -1], np.int64),
        "four": np.asarray([4], np.int64),
        "s0": np.asarray([1], np.int64), "s1": np.asarray([9], np.int64),
        "s_ax": np.asarray([1], np.int64), "s_st": np.asarray([2], np.int64),
        "r0": np.asarray(0, np.int64), "r4": np.asarray(4, np.int64),
        "r1": np.asarray(1, np.int64),
        "eshape": np.asarray([4, 4], np.int64),
        "cshape": np.asarray([4, 4], np.int64),
        "gw": rng.standard_normal((3, 8)).astype(np.float32),
        "gb": rng.standard_normal((3,)).astype(np.float32),
    }
    return _write(path, nodes, inits, ["N", 4, 6, 6], ["N", 3])


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_onnx")
    cnn = str(d / "resnet_tiny.onnx")
    torch.manual_seed(0)
    _export_onnx(TorchGolden().eval(), cnn)
    w = _weights(np.random.default_rng(11))
    bert = str(d / "mini_bert.onnx")
    _export_minibert(w, bert)
    gpt = str(d / "mini_gpt.onnx")
    _export_minigpt(w, gpt)
    rng = np.random.default_rng(3)
    return {
        "cnn": (cnn, rng.standard_normal((4, 3, 32, 32)).astype(np.float32)),
        "bert": (bert, _ids(12)),
        "gpt": (gpt, _ids(13)),
        "ops": (_ops_graph(d / "ops.onnx"),
                rng.standard_normal((3, 3, 8, 8)).astype(np.float32)),
        "shape_ops": (_shape_ops_graph(d / "shape_ops.onnx"),
                      rng.standard_normal((2, 4, 6, 6)).astype(np.float32)),
    }


@pytest.mark.parametrize("name", ["cnn", "bert", "gpt", "ops", "shape_ops"])
def test_parse_matches_jax(graphs, name):
    path, _ = graphs[name]
    jgr, tgr = jg.parse_onnx(path), pg.parse_onnx(path)
    assert (tgr.input_name, tgr.input_shape, tgr.output_name) == (
        jgr.input_name, jgr.input_shape, jgr.output_name)
    assert [(n.op_type, n.inputs, n.outputs) for n in tgr.nodes] == [
        (n.op_type, n.inputs, n.outputs) for n in jgr.nodes]
    assert sorted(tgr.initializers) == sorted(jgr.initializers)
    for k, v in jgr.initializers.items():
        np.testing.assert_array_equal(tgr.initializers[k], v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["cnn", "bert", "gpt", "ops", "shape_ops"])
def test_executor_matches_jax(graphs, name, dtype):
    path, x = graphs[name]
    jspec, jparams = jg.build_onnx_model(path)
    tspec, tparams = pg.build_onnx_model(path, device="cpu")
    assert (tspec.input_shape, tspec.output_shape) == (jspec.input_shape,
                                                       jspec.output_shape)
    want = np.asarray(jax.jit(lambda p, v: jspec.apply(
        p, v, dtype=getattr(jnp, dtype)))(jparams, x))
    got = tspec.apply(tparams, torch.from_numpy(x),
                      dtype=getattr(torch, dtype)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_data_dependent_shape_refuses_and_unknown_op_names_itself(tmp_path):
    path = _write(tmp_path / "dyn.onnx",
                  [ow.node("Cast", ["input"], ["sh"], [ow.attr_int("to", 7)]),
                   ow.node("Reshape", ["input", "sh"], ["output"])],
                  {}, ["N", 2], ["N", 2])
    with pytest.raises(NotImplementedError, match="data-dependent"):
        pg.build_onnx_model(path, device="cpu")
    path = _write(tmp_path / "op.onnx",
                  [ow.node("Einsum", ["input"], ["output"])], {}, ["N", 2],
                  ["N", 2])
    with pytest.raises(NotImplementedError, match="'Einsum'"):
        pg.build_onnx_model(path, device="cpu")
    path = _write(tmp_path / "gather.onnx",
                  [ow.node("Gather", ["input", "bad"], ["output"],
                           [ow.attr_int("axis", 1)])],
                  {"bad": np.asarray([5], np.int64)}, ["N", 2], ["N", 1])
    with pytest.raises(ValueError, match="out of bounds"):
        pg.build_onnx_model(path, device="cpu")


def test_worker_serves_onnx_end_to_end(graphs):
    """An existing ``.onnx`` model_path is the lane's model: the engine
    runs the graph, /infer answers JAX's executor's rows (f32), a short
    input zero-pads, and the cache and batch lane agree."""
    path, ids = graphs["bert"]
    jspec, jparams = jg.build_onnx_model(path)
    want = np.asarray(jspec.apply(jparams, ids))
    for unified in (True, False):
        w = WorkerNode(WorkerConfig(model="onnx", model_path=path,
                                    dtype="float32", device="cpu",
                                    batch_buckets=(1, 2, 4),
                                    unified_stateless=unified))
        try:
            assert w.engine.spec.name == "onnx:mini_bert.onnx"
            for r in range(4):
                out = w.handle_infer({"request_id": f"b{r}",
                                      "input_data": ids[r].tolist()})
                np.testing.assert_allclose(out["output_data"], want[r],
                                           atol=1e-5, rtol=1e-5)
            short = w.handle_infer({"request_id": "s",
                                    "input_data": ids[1, :10].tolist()})
            np.testing.assert_allclose(short["output_data"], want[1],
                                       atol=1e-5, rtol=1e-5)
            again = w.handle_infer({"request_id": "s2",
                                    "input_data": ids[0].tolist()})
            assert again["cached"]
        finally:
            w.stop()


def test_worker_node_argv_serves_the_graph_over_http(graphs):
    """``worker_node <port> <id> <file>.onnx`` (the reference's command
    line) in a subprocess on the CPU: /infer answers the graph's rows;
    with a bert and a yolo lane served beside it in the same process, no
    module of JAX or of the JAX package is loaded."""
    path, x = graphs["cnn"]
    jspec, jparams = jg.build_onnx_model(path)
    want = np.asarray(jspec.apply(jparams, x[:1]))[0]
    a, node, model, mpath = cli.worker_node_args(["8001", "w1", path])
    assert (node, model, mpath) == ("w1", "onnx", path)
    code = (
        "import json, sys, urllib.request\n"
        "from tpu_engine_torch.serving import cli\n"
        "from tpu_engine_torch.serving.app import serve_worker\n"
        "from tpu_engine_torch.utils.config import WorkerConfig\n"
        f"a, node, model, path = cli.worker_node_args(['0', 'w1', {path!r},"
        " '--device', 'cpu', '--dtype', 'float32'])\n"
        "w, s = serve_worker(WorkerConfig(port=0, node_id=node, model=model,"
        " model_path=path, device=a.device, dtype=a.dtype))\n"
        f"body = json.dumps({{'request_id': 'r', 'input_data': "
        f"{x[0].ravel().tolist()!r}}}).encode()\n"
        "out = json.loads(urllib.request.urlopen(urllib.request.Request("
        "f'http://127.0.0.1:{s.port}/infer', data=body), timeout=60)"
        ".read())\n"
        "s.stop(); w.stop()\n"
        "from tpu_engine_torch.serving.worker import WorkerNode\n"
        "for model, req in (('bert-small-test', {'input_data': [5.0, 7.0]}),"
        " ('yolov8n-small-test', {'input_data': [1.0], 'shape': [32, 32, 3]}"
        ")):\n"
        "    wk = WorkerNode(WorkerConfig(model=model, device='cpu',"
        " shape_buckets=((32, 32, 3),)))\n"
        "    assert wk.handle_infer(dict(req, request_id='m'))['output_data']\n"
        "    wk.stop()\n"
        "mods = ['tpu_engine_torch.models.onnx_graph',"
        " 'tpu_engine_torch.models.import_weights',"
        " 'tpu_engine_torch.models.bert', 'tpu_engine_torch.models.yolo']\n"
        "assert all(m in sys.modules for m in mods)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'"
        " or m.startswith(('jax.', 'tpu_engine.')) or m == 'tpu_engine')\n"
        "print(json.dumps({'out': out['output_data'], 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    np.testing.assert_allclose(got["out"], want, atol=1e-5, rtol=1e-4)


def test_infer_over_http_answers_the_graph(graphs):
    path, x = graphs["ops"]
    jspec, jparams = jg.build_onnx_model(path)
    want = np.asarray(jspec.apply(jparams, x))
    w, s = serve_worker(WorkerConfig(port=0, model="onnx", model_path=path,
                                     dtype="float32", device="cpu"))
    try:
        for r in range(len(x)):
            body = json.dumps({"request_id": f"h{r}",
                               "input_data": x[r].ravel().tolist()}).encode()
            out = json.loads(urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{s.port}/infer", data=body),
                timeout=60).read())
            np.testing.assert_allclose(out["output_data"], want[r],
                                       atol=1e-5, rtol=1e-4)
    finally:
        s.stop()
        w.stop()
