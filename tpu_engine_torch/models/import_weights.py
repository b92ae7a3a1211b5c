"""Pretrained-weight importers: HF/torch checkpoints to the port's parameter
trees (counterpart of ``tpu_engine/models/import_weights.py``; same
functions, name maps and results).

- ``load_state_dict`` reads a checkpoint into a flat ``{name: ndarray}``
  dict: a ``.safetensors`` file (its own reader: a little-endian u64
  header length, a JSON header of dtype, shape and byte offsets, then the
  raw little-endian bytes; bf16 through a torch view, returned as f32), a
  torch ``.bin``/``.pt``/``.pth`` pickle (``torch.load(weights_only=True)``,
  a nested ``state_dict`` unwrapped), or an HF checkpoint directory, with
  either sharded ``*.index.json``. No ``safetensors`` or ``transformers``
  package is needed.
- ``import_gpt2``, ``import_llama``, ``import_bert`` and
  ``import_resnet50_v1`` map a state dict onto the JAX package's parameter
  tree as numpy arrays (stacked (L, ...) blocks, HWIO conv kernels), the
  tree ``models.convert.params_from_jax`` takes; ``load_pretrained``
  returns it converted, on a device, in the compute dtype.
- ``load_onnx_initializers`` pulls every initializer out of an ONNX file
  with the dependency-free protobuf reader that ``models.onnx_graph``
  shares (``_iter_fields``, ``_parse_tensor``).
- ``importer_for``, ``model_name_from_hf`` and ``hf_spec_kwargs`` pick
  the importer and the registry model (geometry included) of a
  checkpoint.

Malformed checkpoints (a missing tensor, a geometry that does not match
the model) raise KeyError or ValueError.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional

import numpy as np

__all__ = [
    "load_state_dict",
    "import_gpt2",
    "import_bert",
    "import_llama",
    "import_resnet50_v1",
    "load_onnx_initializers",
    "load_pretrained",
]


# -- checkpoint containers -----------------------------------------------------

# safetensors dtype names -> numpy dtypes (BF16 is read as uint16 and
# widened through torch).
_ST_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16,
              "I64": np.int64, "I32": np.int32, "I16": np.int16,
              "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_,
              "BF16": np.uint16}


def _load_safetensors(path: str) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file: u64 header length, JSON header, data."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(buf[8:8 + n])
    data = memoryview(buf)[8 + n:]
    out: Dict[str, np.ndarray] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = meta["dtype"]
        if dtype not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor '{name}' has unsupported "
                             f"dtype {dtype}")
        begin, end = meta["data_offsets"]
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: tensor '{name}' offsets "
                             f"{begin}..{end} outside the data")
        arr = np.frombuffer(data[begin:end], dtype=_ST_DTYPES[dtype])
        arr = arr.reshape(meta["shape"])
        if dtype == "BF16":
            import torch

            arr = torch.from_numpy(arr.copy()).view(
                torch.bfloat16).float().numpy()
        out[name] = arr
    return out


def _load_torch_bin(path: str) -> Dict[str, np.ndarray]:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd and not any(
            hasattr(v, "numpy") for v in sd.values()):
        sd = sd["state_dict"]
    return {k: v.float().numpy() if v.dtype.is_floating_point else v.numpy()
            for k, v in sd.items() if hasattr(v, "numpy")}


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint file or HF checkpoint directory into a flat
    ``{name: ndarray}`` dict (floating tensors of a torch pickle, and bf16
    safetensors, as f32)."""
    if os.path.isdir(path):
        for index in ("model.safetensors.index.json",
                      "pytorch_model.bin.index.json"):
            ipath = os.path.join(path, index)
            if os.path.exists(ipath):
                with open(ipath) as f:
                    shards = sorted(set(json.load(f)["weight_map"].values()))
                out: Dict[str, np.ndarray] = {}
                for shard in shards:
                    out.update(load_state_dict(os.path.join(path, shard)))
                return out
        for name in ("model.safetensors", "pytorch_model.bin"):
            fpath = os.path.join(path, name)
            if os.path.exists(fpath):
                return load_state_dict(fpath)
        raise FileNotFoundError(
            f"no model.safetensors / pytorch_model.bin under {path}")
    if path.endswith(".safetensors"):
        return _load_safetensors(path)
    return _load_torch_bin(path)


def _strip(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    if any(k.startswith(prefix) for k in sd):
        return {k[len(prefix):] if k.startswith(prefix) else k: v
                for k, v in sd.items()}
    return sd


def _f32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


def _stack(per_layer):
    """Per-layer trees of one structure -> one tree of stacked (L, ...)
    arrays (the JAX package's scanned-block layout)."""
    first = per_layer[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in per_layer]) for k in first}
    return np.stack(per_layer)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"checkpoint does not match the model: {what}")


def _n_layers(sd, prefix: str, index: int) -> int:
    layers = [int(k.split(".")[index]) for k in sd if k.startswith(prefix)]
    if not layers:
        raise KeyError(f"no '{prefix}*' tensors in the checkpoint")
    return 1 + max(layers)


# -- GPT-2 ---------------------------------------------------------------------

def import_gpt2(sd: Dict[str, np.ndarray], cfg=None) -> dict:
    """HF GPT-2 state dict -> transformer tree. HF's ``Conv1D`` stores
    (in, out), the dense layout; the fused ``c_attn`` (D, 3D) splits into
    wq/wk/wv; the LM head is tied to ``wte`` (``head.kernel = wte.T``, a
    zero bias) unless ``lm_head.weight`` is present."""
    sd = _strip(sd, "transformer.")
    d = sd["wte.weight"].shape[1]
    n_layers = _n_layers(sd, "h.", 1)
    if cfg is not None:
        _check(cfg.n_layers == n_layers,
               f"n_layers {cfg.n_layers} != {n_layers}")
        _check(cfg.d_model == d, f"d_model {cfg.d_model} != {d}")

    blocks = []
    for i in range(n_layers):
        p = f"h.{i}."
        ca_w = _f32(sd[p + "attn.c_attn.weight"])
        ca_b = _f32(sd[p + "attn.c_attn.bias"])
        wq, wk, wv = np.split(ca_w, 3, axis=1)
        bq, bk, bv = np.split(ca_b, 3)
        blocks.append({
            "ln1": {"scale": _f32(sd[p + "ln_1.weight"]),
                    "bias": _f32(sd[p + "ln_1.bias"])},
            "attn": {
                "wq": {"kernel": wq, "bias": bq},
                "wk": {"kernel": wk, "bias": bk},
                "wv": {"kernel": wv, "bias": bv},
                "wo": {"kernel": _f32(sd[p + "attn.c_proj.weight"]),
                       "bias": _f32(sd[p + "attn.c_proj.bias"])},
            },
            "ln2": {"scale": _f32(sd[p + "ln_2.weight"]),
                    "bias": _f32(sd[p + "ln_2.bias"])},
            "mlp": {
                "fc": {"kernel": _f32(sd[p + "mlp.c_fc.weight"]),
                       "bias": _f32(sd[p + "mlp.c_fc.bias"])},
                "proj": {"kernel": _f32(sd[p + "mlp.c_proj.weight"]),
                         "bias": _f32(sd[p + "mlp.c_proj.bias"])},
            },
        })

    wte = _f32(sd["wte.weight"])
    head_w = _f32(sd["lm_head.weight"]) if "lm_head.weight" in sd else wte
    return {
        "tok_embed": {"table": wte},
        "pos_embed": {"table": _f32(sd["wpe.weight"])},
        "blocks": _stack(blocks),
        "ln_f": {"scale": _f32(sd["ln_f.weight"]),
                 "bias": _f32(sd["ln_f.bias"])},
        "head": {"kernel": np.ascontiguousarray(head_w.T),
                 "bias": np.zeros((head_w.shape[0],), np.float32)},
    }


# -- Llama family --------------------------------------------------------------

def _linear_nobias(sd, key):
    """torch nn.Linear without bias -> dense {kernel (in, out), zero
    bias}."""
    w = _f32(sd[key + ".weight"])
    return {"kernel": np.ascontiguousarray(w.T),
            "bias": np.zeros((w.shape[0],), np.float32)}


def import_llama(sd: Dict[str, np.ndarray], cfg=None) -> dict:
    """HF ``LlamaForCausalLM`` state dict -> transformer tree (rmsnorm,
    rope, swiglu, GQA): ``self_attn.{q,k,v,o}_proj`` -> wq/wk/wv/wo,
    ``mlp.{gate,up,down}_proj`` -> gate/up/proj (transposed, zero biases),
    ``input_layernorm``/``post_attention_layernorm`` -> ln1/ln2,
    ``model.norm`` -> ln_f, ``lm_head`` -> head (the tied
    ``embed_tokens`` when absent)."""
    sd = _strip(sd, "model.")
    n_layers = _n_layers(sd, "layers.", 1)
    if cfg is not None:
        _check(cfg.n_layers == n_layers,
               f"n_layers {cfg.n_layers} != {n_layers}")
        _check(cfg.norm == "rmsnorm" and cfg.pos == "rope",
               "not a llama-dialect config")

    blocks = []
    for i in range(n_layers):
        p = f"layers.{i}."
        blocks.append({
            "ln1": {"scale": _f32(sd[p + "input_layernorm.weight"])},
            "attn": {
                "wq": _linear_nobias(sd, p + "self_attn.q_proj"),
                "wk": _linear_nobias(sd, p + "self_attn.k_proj"),
                "wv": _linear_nobias(sd, p + "self_attn.v_proj"),
                "wo": _linear_nobias(sd, p + "self_attn.o_proj"),
            },
            "ln2": {"scale": _f32(sd[p + "post_attention_layernorm.weight"])},
            "mlp": {
                "gate": _linear_nobias(sd, p + "mlp.gate_proj"),
                "up": _linear_nobias(sd, p + "mlp.up_proj"),
                "proj": _linear_nobias(sd, p + "mlp.down_proj"),
            },
        })

    embed = _f32(sd["embed_tokens.weight"])
    head_w = _f32(sd["lm_head.weight"]) if "lm_head.weight" in sd else embed
    return {
        "tok_embed": {"table": embed},
        "blocks": _stack(blocks),
        "ln_f": {"scale": _f32(sd["norm.weight"])},
        "head": {"kernel": np.ascontiguousarray(head_w.T),
                 "bias": np.zeros((head_w.shape[0],), np.float32)},
    }


# -- BERT ----------------------------------------------------------------------

def _linear(sd, key):
    """torch nn.Linear (out, in) -> dense {kernel (in, out), bias}."""
    return {"kernel": np.ascontiguousarray(_f32(sd[key + ".weight"]).T),
            "bias": _f32(sd[key + ".bias"])}


def _ln(sd, key):
    return {"scale": _f32(sd[key + ".weight"]), "bias": _f32(sd[key + ".bias"])}


def import_bert(sd: Dict[str, np.ndarray], cfg=None,
                n_outputs: int = 2) -> dict:
    """HF BERT (QA head) state dict -> transformer tree (post-LN):
    ``attention.output.LayerNorm`` -> ln1 (after the attention residual),
    ``output.LayerNorm`` -> ln2 (after the FFN residual). The pooler is
    skipped; without ``qa_outputs`` (a plain BertModel) the head is
    zero."""
    sd = _strip(sd, "bert.")
    n_layers = _n_layers(sd, "encoder.layer.", 2)
    d = sd["embeddings.word_embeddings.weight"].shape[1]
    if cfg is not None:
        _check(cfg.n_layers == n_layers and cfg.d_model == d,
               f"(n_layers, d_model) ({cfg.n_layers}, {cfg.d_model}) != "
               f"({n_layers}, {d})")

    blocks = []
    for i in range(n_layers):
        p = f"encoder.layer.{i}."
        blocks.append({
            "ln1": _ln(sd, p + "attention.output.LayerNorm"),
            "attn": {
                "wq": _linear(sd, p + "attention.self.query"),
                "wk": _linear(sd, p + "attention.self.key"),
                "wv": _linear(sd, p + "attention.self.value"),
                "wo": _linear(sd, p + "attention.output.dense"),
            },
            "ln2": _ln(sd, p + "output.LayerNorm"),
            "mlp": {
                "fc": _linear(sd, p + "intermediate.dense"),
                "proj": _linear(sd, p + "output.dense"),
            },
        })

    if "qa_outputs.weight" in sd:
        head = _linear(sd, "qa_outputs")
    else:
        head = {"kernel": np.zeros((d, n_outputs), np.float32),
                "bias": np.zeros((n_outputs,), np.float32)}
    return {
        "tok_embed": {"table": _f32(sd["embeddings.word_embeddings.weight"])},
        "pos_embed": {"table": _f32(
            sd["embeddings.position_embeddings.weight"])},
        "type_embed": {"table": _f32(
            sd["embeddings.token_type_embeddings.weight"])},
        "embed_ln": _ln(sd, "embeddings.LayerNorm"),
        "blocks": _stack(blocks),
        "head": head,
    }


# -- ResNet-50 v1.5 ------------------------------------------------------------

def _conv(sd, key):
    """torch Conv2d OIHW -> conv {kernel HWIO}."""
    return {"kernel": np.ascontiguousarray(
        _f32(sd[key + ".weight"]).transpose(2, 3, 1, 0))}


def _bn(sd, key):
    return {"scale": _f32(sd[key + ".weight"]),
            "bias": _f32(sd[key + ".bias"]),
            "mean": _f32(sd[key + ".running_mean"]),
            "var": _f32(sd[key + ".running_var"])}


def import_resnet50_v1(sd: Dict[str, np.ndarray]) -> dict:
    """HF ``ResNetForImageClassification`` (microsoft/resnet-50 layout)
    state dict -> ``resnet50-v1`` tree. Depths [3, 4, 6, 3]; block j's
    ``layer.{0,1,2}`` -> conv1/2/3, ``shortcut`` -> proj/proj_bn."""
    sd = _strip(sd, "resnet.")
    params = {
        "stem": _conv(sd, "embedder.embedder.convolution"),
        "stem_bn": _bn(sd, "embedder.embedder.normalization"),
    }
    for s, depth in enumerate((3, 4, 6, 3)):
        for b in range(depth):
            p = f"encoder.stages.{s}.layers.{b}."
            block = {}
            for j in range(3):
                block[f"conv{j+1}"] = _conv(sd, p + f"layer.{j}.convolution")
                block[f"bn{j+1}"] = _bn(sd, p + f"layer.{j}.normalization")
            if p + "shortcut.convolution.weight" in sd:
                block["proj"] = _conv(sd, p + "shortcut.convolution")
                block["proj_bn"] = _bn(sd, p + "shortcut.normalization")
            params[f"stage{s}_block{b}"] = block
    if "classifier.1.weight" in sd:
        params["head"] = _linear(sd, "classifier.1")
    else:  # a plain ResNetModel: no classifier
        width = params["stage3_block0"]["conv3"]["kernel"].shape[-1]
        params["head"] = {"kernel": np.zeros((width, 1000), np.float32),
                          "bias": np.zeros((1000,), np.float32)}
    return params


# -- ONNX ----------------------------------------------------------------------

# A minimal protobuf wire-format reader, enough for an ONNX ModelProto
# without the `onnx` package. Wire types: 0 varint, 1 fixed64,
# 2 length-delimited, 5 fixed32.

def _read_varint(buf: bytes, i: int):
    shift = result = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated protobuf varint")
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        if i > n:
            raise ValueError("truncated protobuf field")
        yield field, wire, val


_ONNX_DTYPES = {1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32,
                7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64}


def _unpack_varints(val, out: list) -> None:
    i = 0
    while i < len(val):
        v, i = _read_varint(val, i)
        out.append(v)


def _parse_tensor(buf: bytes):
    """A TensorProto -> (name, ndarray)."""
    dims, dtype, name = [], 1, ""
    raw = None
    floats, int64s, int32s = [], [], []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            if wire == 0:
                dims.append(val)
            else:  # packed
                _unpack_varints(val, dims)
        elif field == 2:
            dtype = val
        elif field == 4:
            if wire == 5:
                floats.append(struct.unpack("<f", val)[0])
            else:
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
        elif field == 5:
            if wire == 0:
                int32s.append(val)
            else:
                _unpack_varints(val, int32s)
        elif field == 7:
            if wire == 0:
                int64s.append(val)
            else:
                _unpack_varints(val, int64s)
        elif field == 8:
            name = val.decode()
        elif field == 9:
            raw = val
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif floats:
        arr = np.asarray(floats, np.float32)
    elif int64s:
        arr = np.asarray(int64s, np.int64)
    elif int32s:
        arr = np.asarray(int32s, np.int32)
    else:
        arr = np.zeros((0,), np_dtype)
    return name, arr.reshape(dims) if dims else arr


def load_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Every initializer of an ONNX file (ModelProto field 7 -> GraphProto
    field 5 -> TensorProto)."""
    with open(path, "rb") as f:
        buf = f.read()
    out: Dict[str, np.ndarray] = {}
    for field, _wire, val in _iter_fields(buf):
        if field == 7:  # ModelProto.graph
            for gfield, _gwire, gval in _iter_fields(val):
                if gfield == 5:  # GraphProto.initializer
                    name, arr = _parse_tensor(gval)
                    out[name] = arr
    return out


# -- dispatch ------------------------------------------------------------------

def _config(spec):
    return getattr(spec, "config", None)


_IMPORTERS = {
    "gpt2": lambda sd, spec: import_gpt2(sd, _config(spec)),
    "bert": lambda sd, spec: import_bert(sd, _config(spec)),
    "llama": lambda sd, spec: import_llama(sd, _config(spec)),
    # Mistral checkpoints use the llama layout (sliding_window lives in
    # the config, not the weights).
    "mistral": lambda sd, spec: import_llama(sd, _config(spec)),
    "resnet50-v1": lambda sd, spec: import_resnet50_v1(sd),
}


def importer_for(model_name: str):
    """Longest-prefix importer lookup: 'gpt2', 'bert', 'resnet50-v1' (and
    size variants such as 'bert-small-test') resolve to their family;
    None when there is none (gpt2-moe has router and expert weights a
    dense checkpoint cannot fill)."""
    best = None
    for family in _IMPORTERS:
        if (model_name == family or model_name.startswith(family)) and (
                best is None or len(family) > len(best)):
            best = family
    if best and model_name.startswith("gpt2-moe"):
        return None
    return _IMPORTERS.get(best) if best else None


# HF config.json model_type -> the registry family with an importer. ResNet
# maps to the v1.5 model (the HF/torchvision layout).
_HF_MODEL_TYPES = {"gpt2": "gpt2", "bert": "bert", "llama": "llama",
                   "resnet": "resnet50-v1"}


def _hf_config(path: str) -> Optional[dict]:
    cpath = os.path.join(path, "config.json") if os.path.isdir(path) else None
    if not cpath or not os.path.exists(cpath):
        return None
    with open(cpath) as f:
        return json.load(f)


def model_name_from_hf(path: str) -> Optional[str]:
    """The registry model an HF checkpoint directory's weights import into
    (its config.json's ``model_type``); None when unrecognized or not an
    HF directory."""
    cfg = _hf_config(path)
    return None if cfg is None else _HF_MODEL_TYPES.get(
        cfg.get("model_type", ""))


def hf_spec_kwargs(path: str) -> dict:
    """Registry-model kwargs from an HF checkpoint directory's config.json:
    the geometry and the shape-invariant fields (rope_theta, the norm eps,
    mistral's sliding_window, forwarded even when null) come from the
    checkpoint, not the registry defaults."""
    cfg = _hf_config(path)
    if cfg is None:
        return {}
    mt = cfg.get("model_type", "")
    if mt in ("llama", "mistral"):
        out = {
            "vocab": cfg["vocab_size"],
            "n_layers": cfg["num_hidden_layers"],
            "d_model": cfg["hidden_size"],
            "n_heads": cfg["num_attention_heads"],
            "n_kv_heads": cfg.get("num_key_value_heads",
                                  cfg["num_attention_heads"]),
            "d_ff": cfg["intermediate_size"],
            "max_seq": cfg["max_position_embeddings"],
            "rope_theta": cfg.get("rope_theta", 10000.0),
            "ln_eps": cfg.get("rms_norm_eps", 1e-5),
        }
        if mt == "mistral":
            out["sliding_window"] = cfg.get("sliding_window")
        return out
    if mt == "gpt2":
        return {
            "vocab": cfg["vocab_size"],
            "n_layers": cfg["n_layer"],
            "d_model": cfg["n_embd"],
            "n_heads": cfg["n_head"],
            "d_ff": cfg.get("n_inner") or 4 * cfg["n_embd"],
            "max_seq": cfg["n_positions"],
        }
    return {}


def load_pretrained(model_name: str, path: str, spec=None, device=None,
                    dtype="bfloat16"):
    """A checkpoint file or directory -> the port's parameter tree of
    registry model ``model_name`` on ``device`` (None = the CUDA card),
    matmul and conv kernels in ``dtype``. ValueError when the family has
    no importer. For an HF directory the spec (when not given) is built
    with ``hf_spec_kwargs``, so the architecture is the checkpoint's."""
    from tpu_engine_torch.models.convert import params_from_jax

    imp = importer_for(model_name)
    if imp is None:
        raise ValueError(f"no pretrained-weight importer for '{model_name}'")
    if spec is None:
        from tpu_engine_torch.models.registry import create_model

        spec = create_model(model_name, **hf_spec_kwargs(path))
    tree = imp(load_state_dict(path), spec)
    return params_from_jax(tree, _config(spec) if "blocks" in tree else None,
                           device=device, dtype=dtype)
