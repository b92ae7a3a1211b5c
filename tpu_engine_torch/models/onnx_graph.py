"""Serve an arbitrary ``.onnx`` file (counterpart of
``tpu_engine/models/onnx_graph.py``; same functions, op set and results).

The reference loads any ONNX model and serves its input 0 / output 0,
dynamic dims collapsed to 1. Here the graph is parsed with the
dependency-free protobuf reader of ``models.import_weights`` (no ``onnx``
package, no ONNX Runtime) and each node runs as PyTorch ops on the
engine's device, eagerly, one batch at a time.

Op set: the CNN-classifier subset (Conv, Gemm, MatMul,
BatchNormalization, Relu, Sigmoid, Clip, MaxPool, AveragePool,
GlobalAveragePool, Add, Sub, Mul, Div, Flatten, Reshape, Transpose,
Concat, Softmax, Identity, Dropout, Constant) and the transformer
exporters' subset (Gather, Slice, Split, Erf, Gelu, ReduceMean, ReduceSum,
LayerNormalization, Where, Cast, Shape, Unsqueeze, Squeeze, Expand,
ConstantOfShape, Range, Trilu, Min, Max, Pow, Sqrt, Tanh, Neg, Exp, Log,
Abs, Floor, Ceil, Equal, Greater, Less); anything else refuses by name.

Numerics follow the JAX executor: Conv, Gemm and MatMul round their
operands to the compute dtype and sum in f32; BatchNormalization,
LayerNormalization, Softmax, Sigmoid, Gelu, AveragePool and the float
unaries run in f32; other ops keep their inputs' dtype. ONNX's int64 and
float64 become int32 and float32 (Cast targets and initializers), as in
JAX, where 64-bit types are off. Layout is ONNX's NCHW with OIHW kernels.
Attention inside a graph (MatMul, Softmax) stays plain PyTorch ops, as it
is plain XLA in JAX.

Shape operands (of Reshape, Slice, Split, Expand, Unsqueeze, Squeeze,
ConstantOfShape, Range, Trilu) must be static: initializers, Constant,
Shape and Range outputs, and Slices and Reshapes of those, kept as numpy
arrays. One computed from the data refuses (NotImplementedError), as the
JAX executor does under jit.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_engine_torch.models.import_weights import (
    _iter_fields,
    _parse_tensor,
    _read_varint,
)
from tpu_engine_torch.models.registry import ModelSpec


def _signed(v: int) -> int:
    """Protobuf varints encode negative int64 as 2^64 + v."""
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    input_name: str
    input_shape: Tuple[int, ...]   # per the model file; 0 = dynamic dim
    output_name: str


def _parse_attr(buf: bytes):
    name, atype = "", None
    f_val = i_val = s_val = t_val = None
    floats: List[float] = []
    ints: List[int] = []
    for fld, wire, val in _iter_fields(buf):
        if fld == 1:
            name = val.decode()
        elif fld == 2:
            f_val = struct.unpack("<f", val)[0]
        elif fld == 3:
            i_val = _signed(val)
        elif fld == 4:
            s_val = val
        elif fld == 5:
            t_val = _parse_tensor(val)[1]
        elif fld == 7:
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
        elif fld == 8:
            if wire == 0:
                ints.append(_signed(val))
            else:
                i = 0
                while i < len(val):
                    v, i = _read_varint(val, i)
                    ints.append(_signed(v))
        elif fld == 20:
            atype = val
    # AttributeProto.type: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7
    if atype == 1 or (atype is None and f_val is not None):
        return name, f_val
    if atype == 2 or (atype is None and i_val is not None):
        return name, i_val
    if atype == 3 or (atype is None and s_val is not None):
        return name, s_val.decode() if s_val is not None else ""
    if atype == 4 or (atype is None and t_val is not None):
        return name, t_val
    if atype == 6 or (atype is None and floats):
        return name, floats
    if atype == 7 or (atype is None and ints):
        return name, ints
    return name, i_val if i_val is not None else f_val


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode("", [], [])
    for fld, _wire, val in _iter_fields(buf):
        if fld == 1:
            node.inputs.append(val.decode())
        elif fld == 2:
            node.outputs.append(val.decode())
        elif fld == 4:
            node.op_type = val.decode()
        elif fld == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: bytes) -> Tuple[str, Tuple[int, ...]]:
    name, dims = "", []
    for fld, _w, val in _iter_fields(buf):
        if fld == 1:
            name = val.decode()
        elif fld == 2:  # TypeProto
            for tf, _tw, tval in _iter_fields(val):
                if tf == 1:  # tensor_type
                    for sf, _sw, sval in _iter_fields(tval):
                        if sf == 2:  # shape
                            for df, _dw, dval in _iter_fields(sval):
                                if df == 1:  # dim
                                    dim = 0  # dynamic unless dim_value set
                                    for ddf, _ddw, ddval in _iter_fields(dval):
                                        if ddf == 1:
                                            dim = ddval
                                    dims.append(int(dim))
    return name, tuple(dims)


def parse_onnx(path: str) -> OnnxGraph:
    """ModelProto field 7 -> GraphProto: nodes (1), initializers (5),
    inputs (11), outputs (12); the data input is the first graph input
    without an initializer (old opsets list initializers among the
    inputs), the output is output 0."""
    with open(path, "rb") as f:
        buf = f.read()
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    inputs: List[Tuple[str, Tuple[int, ...]]] = []
    outputs: List[str] = []
    for fld, _w, val in _iter_fields(buf):
        if fld != 7:
            continue
        for gf, _gw, gval in _iter_fields(val):
            if gf == 1:
                nodes.append(_parse_node(gval))
            elif gf == 5:
                name, arr = _parse_tensor(gval)
                inits[name] = arr
            elif gf == 11:
                inputs.append(_parse_value_info(gval))
            elif gf == 12:
                outputs.append(_parse_value_info(gval)[0])
    data_inputs = [(n, s) for n, s in inputs if n not in inits]
    if not data_inputs or not outputs:
        raise ValueError(f"{path}: no data input/output in ONNX graph")
    in_name, in_shape = data_inputs[0]
    return OnnxGraph(nodes, inits, in_name, in_shape, outputs[0])


# -- values --------------------------------------------------------------------

def _narrow(arr: np.ndarray) -> np.ndarray:
    """ONNX's 64-bit types as the JAX executor holds them: int32, f32."""
    if arr.dtype == np.int64:
        return arr.astype(np.int32)
    if arr.dtype == np.float64:
        return arr.astype(np.float32)
    return arr


def _tensor(v, device) -> torch.Tensor:
    """An environment value as a tensor on ``device`` (static numpy values
    are converted where an op consumes them as data)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.array(_narrow(np.asarray(v)))).to(device)


class _Env:
    """The graph's values by name: tensors computed on ``device``, and the
    static values (numpy): initializers, Constant and Shape and Range
    outputs."""

    def __init__(self, params, static, device):
        self.values: Dict[str, object] = dict(params)
        self.static = static
        self.device = device

    def __getitem__(self, name: str) -> torch.Tensor:
        return _tensor(self.values[name], self.device)

    def __setitem__(self, name: str, value) -> None:
        self.values[name] = value

    def static_value(self, name: str) -> Optional[np.ndarray]:
        if name in self.static:
            return np.asarray(self.static[name])
        v = self.values.get(name)
        return v if isinstance(v, np.ndarray) else None

    def static_ints(self, name: str, op: str) -> List[int]:
        v = self.static_value(name)
        if v is None:
            raise NotImplementedError(
                f"{op}: operand '{name}' is data-dependent; only "
                "initializer/Constant/Shape-derived (static) values are "
                "supported")
        return [int(x) for x in v.ravel()]


# -- ops (NCHW) ----------------------------------------------------------------

def _pair(v, n=2):
    v = list(v) if isinstance(v, (list, tuple)) else [v] * n
    return [int(x) for x in v]


def _auto_pad(attrs) -> str:
    auto = attrs.get("auto_pad", b"")
    return auto.decode() if isinstance(auto, bytes) else str(auto or "")


def _conv_padding(attrs, spatial: int, x_shape, k_shape, strides, dilations):
    auto = _auto_pad(attrs)
    if auto in ("", "NOTSET"):
        pads = _pair(attrs.get("pads", [0] * 2 * spatial), 2 * spatial)
        return [(pads[i], pads[i + spatial]) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    out = []  # SAME_UPPER / SAME_LOWER
    for i in range(spatial):
        in_dim = x_shape[2 + i]
        k = (k_shape[2 + i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + k - in_dim)
        lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
        out.append((lo, total - lo))
    return out


def _torch_pads(padding) -> List[int]:
    """[(lo, hi) per spatial dim] -> F.pad's order (last dim first)."""
    out: List[int] = []
    for lo, hi in reversed(padding):
        out += [lo, hi]
    return out


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    """Rounded to the compute dtype and held in f32: products of such
    operands are exact in f32 and sum there, as preferred_element_type=f32
    sums them."""
    return t.to(dtype).float()


def _op_conv(env, node, dtype):
    x = env[node.inputs[0]]
    w = env[node.inputs[1]]
    spatial = x.dim() - 2
    strides = _pair(node.attrs.get("strides", [1] * spatial), spatial)
    dilations = _pair(node.attrs.get("dilations", [1] * spatial), spatial)
    group = int(node.attrs.get("group", 1))
    padding = _conv_padding(node.attrs, spatial, tuple(x.shape),
                            tuple(w.shape), strides, dilations)
    x = F.pad(_round(x, dtype), _torch_pads(padding))
    y = _CONV[spatial](x, _round(w, dtype), stride=strides,
                       dilation=dilations, groups=group)
    if len(node.inputs) > 2:
        y = y + env[node.inputs[2]].reshape((1, -1) + (1,) * spatial)
    return y


def _op_gemm(env, node, dtype):
    a = env[node.inputs[0]]
    b = env[node.inputs[1]]
    if int(node.attrs.get("transA", 0)):
        a = a.T
    if int(node.attrs.get("transB", 0)):
        b = b.T
    y = _round(a, dtype) @ _round(b, dtype)
    y = y * float(node.attrs.get("alpha", 1.0))
    if len(node.inputs) > 2:
        y = y + float(node.attrs.get("beta", 1.0)) * env[node.inputs[2]]
    return y


def _op_bn(env, node, _dtype):
    x = env[node.inputs[0]].float()
    scale, b, mean, var = (env[n] for n in node.inputs[1:5])
    eps = float(node.attrs.get("epsilon", 1e-5))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = scale.reshape(shape) / torch.sqrt(var.reshape(shape) + eps)
    return x * inv + (b.reshape(shape) - mean.reshape(shape) * inv)


def _pool_dims(node, x):
    spatial = x.dim() - 2
    k = _pair(node.attrs["kernel_shape"], spatial)
    strides = _pair(node.attrs.get("strides", [1] * spatial), spatial)
    pads = _pair(node.attrs.get("pads", [0] * 2 * spatial), 2 * spatial)
    padding = [(pads[i], pads[i + spatial]) for i in range(spatial)]
    return spatial, k, strides, padding


def _op_maxpool(env, node, _dtype):
    x = env[node.inputs[0]]
    spatial, k, strides, padding = _pool_dims(node, x)
    x = F.pad(x, _torch_pads(padding), value=float("-inf"))
    return _MAXPOOL[spatial](x, k, strides)


def _op_avgpool(env, node, _dtype):
    x = env[node.inputs[0]].float()
    spatial, k, strides, padding = _pool_dims(node, x)
    pads = _torch_pads(padding)
    mean = _AVGPOOL[spatial](F.pad(x, pads), k, strides)
    if int(node.attrs.get("count_include_pad", 0)):
        return mean
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), device=x.device)
    return mean / _AVGPOOL[spatial](F.pad(ones, pads), k, strides)


def _op_reshape(env, node, _dtype):
    x = env.values[node.inputs[0]]  # a static value stays static
    if not isinstance(x, np.ndarray):
        x = env[node.inputs[0]]
    shape = env.static_ints(node.inputs[1], "Reshape")
    if not int(node.attrs.get("allowzero", 0)):
        shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return x.reshape(shape)


def _op_clip(env, node, _dtype):
    x = env[node.inputs[0]]
    lo = (env[node.inputs[1]] if len(node.inputs) > 1 and node.inputs[1]
          else node.attrs.get("min"))
    hi = (env[node.inputs[2]] if len(node.inputs) > 2 and node.inputs[2]
          else node.attrs.get("max"))
    if lo is not None:
        x = torch.maximum(x, torch.as_tensor(lo, dtype=x.dtype,
                                             device=x.device))
    if hi is not None:
        x = torch.minimum(x, torch.as_tensor(hi, dtype=x.dtype,
                                             device=x.device))
    return x


def _op_flatten(env, node, _dtype):
    x = env[node.inputs[0]]
    axis = int(node.attrs.get("axis", 1))
    axis = x.dim() + axis if axis < 0 else axis
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return x.reshape(lead, -1)


# ONNX TensorProto elem types -> the JAX executor's dtypes (64-bit types
# narrowed, as there).
_ONNX_DTYPES = {1: torch.float32, 2: torch.uint8, 3: torch.int8,
                5: torch.int16, 6: torch.int32, 7: torch.int32,
                9: torch.bool, 10: torch.float16, 11: torch.float32,
                16: torch.bfloat16}


def _op_gather(env, node):
    data = env[node.inputs[0]]
    axis = int(node.attrs.get("axis", 0))
    axis += data.dim() if axis < 0 else 0
    dim = int(data.shape[axis])
    concrete = env.static_value(node.inputs[1])
    if concrete is not None:
        # Static indices: ORT's bounds exactly (an out-of-range id is a
        # graph bug, refused), negatives wrap.
        ids = np.asarray(concrete, np.int64)
        if ids.size and (ids.min() < -dim or ids.max() >= dim):
            raise ValueError(
                f"Gather: index out of bounds for axis {axis} with dim "
                f"{dim}: indices span [{ids.min()}, {ids.max()}] "
                "(ORT raises here; refusing at graph load)")
        idx = torch.from_numpy(np.where(ids < 0, ids + dim, ids)).to(
            data.device)
    else:
        # Indices from the request (token ids into an embedding): negatives
        # wrap, the rest clamp to [0, dim - 1], as the JAX executor does
        # (ORT would fail the request).
        idx = env[node.inputs[1]].long()
        idx = torch.clamp(torch.where(idx < 0, idx + dim, idx), 0, dim - 1)
    out = torch.index_select(data, axis, idx.reshape(-1))
    return out.reshape(tuple(data.shape[:axis]) + tuple(idx.shape)
                       + tuple(data.shape[axis + 1:]))


def _slice_axis(x, axis: int, start: int, end: int, step: int):
    idx = range(*slice(start, end, step).indices(x.shape[axis]))
    if step > 0:
        return x.narrow(axis, idx.start, len(idx)) if step == 1 else \
            x[(slice(None),) * axis + (slice(idx.start, idx.stop, step),)]
    return torch.index_select(x, axis, torch.tensor(
        list(idx), dtype=torch.long, device=x.device))


def _op_slice(env, node):
    x = env.values[node.inputs[0]]  # a static value stays static
    if not isinstance(x, np.ndarray):
        x = env[node.inputs[0]]
    if len(node.inputs) > 1:  # opset >= 10: starts/ends/axes/steps inputs
        starts = env.static_ints(node.inputs[1], "Slice")
        ends = env.static_ints(node.inputs[2], "Slice")
        axes = (env.static_ints(node.inputs[3], "Slice")
                if len(node.inputs) > 3 and node.inputs[3] else None)
        steps = (env.static_ints(node.inputs[4], "Slice")
                 if len(node.inputs) > 4 and node.inputs[4] else None)
    else:  # opset 1: attributes
        starts = [int(v) for v in node.attrs["starts"]]
        ends = [int(v) for v in node.attrs["ends"]]
        axes = node.attrs.get("axes")
        steps = None
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    for a, s, e, st in zip(axes, starts, ends, steps):
        a = int(a) + (x.ndim if int(a) < 0 else 0)
        # Python's slice clamping is ONNX's (INT64 sentinels, negatives
        # from the end).
        if isinstance(x, np.ndarray):
            x = x[(slice(None),) * a + (slice(s, e, st),)]
        else:
            x = _slice_axis(x, a, s, e, st)
    return x


def _op_split(env, node):
    x = env[node.inputs[0]]
    axis = int(node.attrs.get("axis", 0))
    axis += x.dim() if axis < 0 else 0
    split = node.attrs.get("split")  # opset < 13: attribute
    if split is None and len(node.inputs) > 1 and node.inputs[1]:
        split = env.static_ints(node.inputs[1], "Split")
    if split is None:  # equal parts (opset 18 num_outputs / output count)
        n = int(node.attrs.get("num_outputs", len(node.outputs)))
        chunk = -(-x.shape[axis] // n)  # ceil: the last part may be smaller
        split = [chunk] * (n - 1) + [x.shape[axis] - chunk * (n - 1)]
    return tuple(torch.split(x, [int(s) for s in split], dim=axis))


def _op_reduce(env, node, mean: bool):
    x = env[node.inputs[0]]
    axes = node.attrs.get("axes")  # opset < 18: attribute
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = env.static_ints(node.inputs[1], node.op_type)
    keep = bool(int(node.attrs.get("keepdims", 1)))
    if not axes:
        if int(node.attrs.get("noop_with_empty_axes", 0)):
            return x
        axes = list(range(x.dim()))
    dims = tuple(int(a) for a in axes)
    if mean:
        if not x.is_floating_point():
            x = x.float()
        return torch.mean(x, dim=dims, keepdim=keep)
    return torch.sum(x, dim=dims, keepdim=keep)


def _op_layernorm(env, node, _dtype):
    # Opset-17 LayerNormalization over axes [axis, rank), in f32.
    x = env[node.inputs[0]].float()
    axis = int(node.attrs.get("axis", -1))
    axis += x.dim() if axis < 0 else 0
    axes = tuple(range(axis, x.dim()))
    eps = float(node.attrs.get("epsilon", 1e-5))
    mean = x.mean(dim=axes, keepdim=True)
    var = (x - mean).square().mean(dim=axes, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    y = y * env[node.inputs[1]]
    if len(node.inputs) > 2 and node.inputs[2]:
        y = y + env[node.inputs[2]]
    return y


def _op_unsqueeze(env, node):
    x = env[node.inputs[0]]
    axes = node.attrs.get("axes")
    if axes is None:
        axes = env.static_ints(node.inputs[1], "Unsqueeze")
    rank = x.dim() + len(axes)
    for a in sorted(int(v) + (rank if int(v) < 0 else 0) for v in axes):
        x = x.unsqueeze(a)
    return x


def _op_squeeze(env, node):
    x = env[node.inputs[0]]
    axes = node.attrs.get("axes")
    if axes is None and len(node.inputs) > 1 and node.inputs[1]:
        axes = env.static_ints(node.inputs[1], "Squeeze")
    if not axes:
        return x.squeeze()
    return x.squeeze(tuple(int(a) for a in axes))


def _op_constant_of_shape(env, node):
    shape = tuple(env.static_ints(node.inputs[0], "ConstantOfShape"))
    val = node.attrs.get("value")
    arr = np.asarray(val).ravel() if val is not None else np.zeros(
        1, np.float32)
    dtype = torch.bool if arr.dtype == np.bool_ else (
        torch.int32 if np.issubdtype(arr.dtype, np.integer)
        else torch.float32)
    return torch.full(shape, arr[0].item(), dtype=dtype, device=env.device)


def _op_range(env, node):
    vals = []
    for name in node.inputs[:3]:
        v = env.static_value(name)
        if v is None:
            raise NotImplementedError(
                f"Range: operand '{name}' is data-dependent")
        if not np.issubdtype(np.asarray(v).dtype, np.integer):
            raise NotImplementedError(
                "Range: only integer start/limit/delta supported "
                f"(got dtype {np.asarray(v).dtype})")
        vals.append(int(np.asarray(v).ravel()[0]))
    start, limit, delta = vals
    return np.arange(start, limit, delta, dtype=np.int64)


_F32_UNARY = {"Erf": torch.erf, "Sqrt": torch.sqrt, "Tanh": torch.tanh,
              "Exp": torch.exp, "Log": torch.log}
_UNARY = {"Neg": torch.neg, "Abs": torch.abs, "Floor": torch.floor,
          "Ceil": torch.ceil}

_BINOPS = {"Add": torch.add, "Sub": torch.sub, "Mul": torch.mul,
           "Div": torch.true_divide, "Pow": torch.pow, "Equal": torch.eq,
           "Greater": torch.gt, "Less": torch.lt}


def _eval_node(env: _Env, node: OnnxNode, dtype):
    op = node.op_type
    ins = node.inputs
    if op == "Conv":
        return _op_conv(env, node, dtype)
    if op == "Gemm":
        return _op_gemm(env, node, dtype)
    if op == "MatMul":
        return _round(env[ins[0]], dtype) @ _round(env[ins[1]], dtype)
    if op == "BatchNormalization":
        return _op_bn(env, node, dtype)
    if op == "Relu":
        return torch.relu(env[ins[0]])
    if op == "Sigmoid":
        return torch.sigmoid(env[ins[0]].float())
    if op == "Clip":
        return _op_clip(env, node, dtype)
    if op == "MaxPool":
        return _op_maxpool(env, node, dtype)
    if op == "AveragePool":
        return _op_avgpool(env, node, dtype)
    if op == "GlobalAveragePool":
        x = env[ins[0]].float()
        return x.mean(dim=tuple(range(2, x.dim())), keepdim=True)
    if op in _BINOPS:
        return _BINOPS[op](env[ins[0]], env[ins[1]])
    if op == "Flatten":
        return _op_flatten(env, node, dtype)
    if op == "Reshape":
        return _op_reshape(env, node, dtype)
    if op == "Transpose":
        x = env[ins[0]]
        perm = node.attrs.get("perm")
        return x.permute(*([int(p) for p in perm] if perm
                           else reversed(range(x.dim()))))
    if op == "Concat":
        return torch.cat([env[n] for n in ins],
                         dim=int(node.attrs.get("axis", 0)))
    if op == "Softmax":
        return torch.softmax(env[ins[0]].float(),
                             dim=int(node.attrs.get("axis", -1)))
    if op in ("Identity", "Dropout"):
        return env.values[ins[0]]
    if op == "Constant":
        val = node.attrs.get("value")
        if val is None:
            val = node.attrs.get("value_float", node.attrs.get("value_int"))
        return np.asarray(val)
    if op in _F32_UNARY:
        return _F32_UNARY[op](env[ins[0]].float())
    if op in _UNARY:
        return _UNARY[op](env[ins[0]])
    if op == "Gelu":
        approx = node.attrs.get("approximate", "none")
        approx = approx.decode() if isinstance(approx, bytes) else approx
        return F.gelu(env[ins[0]].float(),
                      approximate="tanh" if approx == "tanh" else "none")
    if op == "Gather":
        return _op_gather(env, node)
    if op == "Slice":
        return _op_slice(env, node)
    if op == "Split":
        return _op_split(env, node)
    if op == "ReduceMean":
        return _op_reduce(env, node, mean=True)
    if op == "ReduceSum":
        return _op_reduce(env, node, mean=False)
    if op == "LayerNormalization":
        return _op_layernorm(env, node, dtype)
    if op == "Where":
        return torch.where(env[ins[0]].bool(), env[ins[1]], env[ins[2]])
    if op == "Cast":
        to = int(node.attrs["to"])
        if to not in _ONNX_DTYPES:
            raise NotImplementedError(
                f"Cast: ONNX elem_type {to} unsupported (supported: "
                f"{sorted(_ONNX_DTYPES)})")
        return env[ins[0]].to(_ONNX_DTYPES[to])
    if op == "Shape":
        # Static: downstream Reshape/Slice/Expand resolve from it.
        v = env.values[ins[0]]
        shp = np.asarray(tuple(v.shape), np.int64)
        start = int(node.attrs.get("start", 0))
        end = node.attrs.get("end")
        return shp[start:int(end) if end is not None else None]
    if op == "Unsqueeze":
        return _op_unsqueeze(env, node)
    if op == "Squeeze":
        return _op_squeeze(env, node)
    if op == "Expand":
        x = env[ins[0]]
        shape = env.static_ints(ins[1], "Expand")
        return torch.broadcast_to(
            x, np.broadcast_shapes(tuple(x.shape), tuple(shape)))
    if op == "ConstantOfShape":
        return _op_constant_of_shape(env, node)
    if op == "Range":
        return _op_range(env, node)
    if op == "Trilu":
        x = env[ins[0]]
        k = (env.static_ints(ins[1], "Trilu")[0]
             if len(ins) > 1 and ins[1] else 0)
        fn = torch.triu if int(node.attrs.get("upper", 1)) else torch.tril
        return fn(x, k)
    if op in ("Min", "Max"):
        fn = torch.minimum if op == "Min" else torch.maximum
        out = env[ins[0]]
        for name in ins[1:]:  # ONNX Min/Max are variadic
            out = fn(out, env[name])
        return out
    raise NotImplementedError(
        f"ONNX op '{op}' is outside the supported subset (CNN ops: Conv/"
        "Gemm/MatMul/BN/Relu/Sigmoid/Clip/Pool/binops/Flatten/Reshape/"
        "Transpose/Concat/Softmax/Identity/Dropout/Constant; transformer "
        "ops: Gather/Slice/Split/Erf/Gelu/ReduceMean/ReduceSum/"
        "LayerNormalization/Where/Cast/Shape/Unsqueeze/Squeeze/Expand/"
        "ConstantOfShape/Range/Trilu/Min/Max/Pow/Sqrt/Tanh/unaries/"
        "comparisons)")


def execute_graph(graph: OnnxGraph, params: Dict[str, torch.Tensor], x,
                  dtype=torch.float32):
    """Run the graph on a batch input ``x`` (a tensor on the params'
    device); returns the output tensor."""
    env = _Env(params, graph.initializers, x.device)
    env[graph.input_name] = x
    for node in graph.nodes:
        out = _eval_node(env, node, dtype)
        if isinstance(out, tuple):  # multi-output nodes (Split)
            for name, o in zip(node.outputs, out):
                if name:  # optional outputs may be omitted ("")
                    env[name] = o
        else:
            env[node.outputs[0]] = out
    return env[graph.output_name]


def _onnx_params(graph: OnnxGraph, device) -> Dict[str, torch.Tensor]:
    """The initializers the graph consumes (some files carry dead ones),
    as tensors on ``device`` (64-bit types narrowed)."""
    used = {n for node in graph.nodes for n in node.inputs}
    return {k: _tensor(v, device) for k, v in graph.initializers.items()
            if k in used}


def build_onnx_model(path: str, device=None
                     ) -> Tuple[ModelSpec, Dict[str, torch.Tensor]]:
    """(ModelSpec, params on ``device``, None = the CUDA card) for an
    arbitrary .onnx file, ready for ``InferenceEngine(spec,
    params=params)``. Dynamic non-batch dims collapse to 1, as the
    reference's do. The output shape comes from one forward on the meta
    device (shapes only, no data)."""
    from tpu_engine_torch.utils.device import resolve_device

    graph = parse_onnx(path)
    per_sample = tuple(int(d) if d else 1 for d in graph.input_shape[1:])
    if not per_sample:
        raise ValueError(f"{path}: input 0 has no per-sample dims")

    def apply(p, x, dtype=torch.float32):
        return execute_graph(graph, p, x.to(dtype), dtype=dtype)

    meta = _onnx_params(graph, "meta")
    out_shape = tuple(apply(meta, torch.zeros((1,) + per_sample,
                                              device="meta")).shape[1:])
    dev = resolve_device(device)
    params = _onnx_params(graph, dev)

    def init(_seed, device_, _dtype):
        return {k: v.to(resolve_device(device_)) for k, v in params.items()}

    spec = ModelSpec(f"onnx:{os.path.basename(path)}", apply=apply,
                     init_fn=init, input_shape=per_sample,
                     output_shape=tuple(int(d) for d in out_shape))
    return spec, params
