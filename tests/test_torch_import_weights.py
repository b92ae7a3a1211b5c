"""The port's checkpoint importers (``tpu_engine_torch.models.
import_weights``) against the JAX package's and against ``safetensors``'
own reader, on HF state dicts the tests build with ``transformers``
(random init, tiny geometries), then the ``import-weights`` command and a
worker serving HF checkpoints. All on the CPU.

Tolerances: the readers and importers are exact (leaf for leaf, equal
arrays); forwards of imported weights against HF's torch forward 2e-4
(the JAX test's bound: f32 sums in another order, erf/tanh GELU).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

import jax

from tests import onnx_writer as ow
from tpu_engine.models import import_weights as jiw
from tpu_engine.models.registry import _ensure_builtin_models_imported
from tpu_engine_torch.models import import_weights as tiw
from tpu_engine_torch.models.convert import params_from_jax
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.models.transformer import transformer_apply
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.worker import WorkerNode
from tpu_engine_torch.utils.config import WorkerConfig

transformers = pytest.importorskip("transformers")
_ensure_builtin_models_imported()


def _sd(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.fixture(scope="module")
def hf_gpt2():
    cfg = transformers.GPT2Config(
        vocab_size=97, n_positions=64, n_embd=64, n_layer=3, n_head=4,
        n_inner=128, resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(cfg).eval()


@pytest.fixture(scope="module")
def hf_bert():
    cfg = transformers.BertConfig(
        vocab_size=99, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        max_position_embeddings=64, type_vocab_size=2,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(1)
    return transformers.BertForQuestionAnswering(cfg).eval()


@pytest.fixture(scope="module")
def hf_llama():
    cfg = transformers.LlamaConfig(
        vocab_size=101, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rope_theta=50000.0)
    torch.manual_seed(2)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def hf_resnet():
    cfg = transformers.ResNetConfig(
        embedding_size=8, hidden_sizes=[16, 32, 64, 128], depths=[3, 4, 6, 3],
        layer_type="bottleneck", num_labels=10)
    torch.manual_seed(3)
    return transformers.ResNetForImageClassification(cfg).eval()


# -- containers ---------------------------------------------------------------

def test_safetensors_reader_matches_safetensors(tmp_path):
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    rng = np.random.default_rng(0)
    f32 = {"a": torch.from_numpy(rng.standard_normal((3, 5)).astype(
               np.float32)),
           "ids": torch.arange(7, dtype=torch.int64),
           "h": torch.from_numpy(rng.standard_normal(4).astype(np.float16)),
           "scalar": torch.tensor(2.5)}
    p = tmp_path / "f32.safetensors"
    save_file(f32, str(p), metadata={"format": "pt"})
    got, want = tiw.load_state_dict(str(p)), load_file(str(p))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])
    bf = {"w": torch.randn(4, 6).to(torch.bfloat16),
          "b": torch.randn(6).to(torch.bfloat16)}
    p = tmp_path / "bf16.safetensors"
    save_file(bf, str(p))
    got = tiw.load_state_dict(str(p))
    jgot = jiw.load_state_dict(str(p))  # safetensors' torch fallback
    for k, v in bf.items():
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], v.float().numpy())
        np.testing.assert_array_equal(got[k], jgot[k])
    (tmp_path / "bad.safetensors").write_bytes(b"\xff" * 12)
    with pytest.raises(ValueError):
        tiw.load_state_dict(str(tmp_path / "bad.safetensors"))


@pytest.mark.parametrize("safe", [True, False])
def test_hf_directories_sharded_and_not(tmp_path, hf_gpt2, safe):
    """save_pretrained directories, whole and sharded (either index), read
    as the JAX reader reads them."""
    for shard in ("10GB", "100KB"):
        d = tmp_path / f"{safe}-{shard}"
        hf_gpt2.save_pretrained(str(d), safe_serialization=safe,
                                max_shard_size=shard)
        names = os.listdir(d)
        index = ("model.safetensors.index.json" if safe
                 else "pytorch_model.bin.index.json")
        assert (index in names) == (shard == "100KB")
        got, want = tiw.load_state_dict(str(d)), jiw.load_state_dict(str(d))
        _tree_equal(got, want)
    p = tmp_path / "ckpt.bin"
    torch.save({"state_dict": hf_gpt2.state_dict()}, p)
    _tree_equal(tiw.load_state_dict(str(p)), jiw.load_state_dict(str(p)))
    with pytest.raises(FileNotFoundError):
        tiw.load_state_dict(str(tmp_path))


# -- importers ----------------------------------------------------------------

def _both(imp_t, imp_j, sd, cfg):
    """The port's and JAX's importer on ``sd``: equal numpy trees, and
    equal port trees after ``params_from_jax``; returns the port's."""
    got = imp_t(sd, cfg) if cfg is not None else imp_t(sd)
    want = imp_j(sd, cfg) if cfg is not None else imp_j(sd)
    want = jax.tree.map(np.asarray, want)
    _tree_equal(got, want)
    t_from_port = params_from_jax(got, cfg, device="cpu", dtype="float32")
    t_from_jax = params_from_jax(want, cfg, device="cpu", dtype="float32")
    _tree_equal(t_from_port, t_from_jax)
    return t_from_port


def test_import_gpt2_matches_jax_and_hf(hf_gpt2):
    spec = tcreate("gpt2", vocab=97, n_layers=3, d_model=64, n_heads=4,
                   d_ff=128, max_seq=64)
    params = _both(tiw.import_gpt2, jiw.import_gpt2, _sd(hf_gpt2),
                   spec.config)
    tokens = np.random.default_rng(1).integers(0, 97, (2, 17))
    with torch.no_grad():
        ref = hf_gpt2(torch.tensor(tokens)).logits.numpy()
    got = transformer_apply(params, torch.from_numpy(tokens), spec.config,
                            dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    with pytest.raises(ValueError, match="n_layers"):
        tiw.import_gpt2(_sd(hf_gpt2), tcreate("gpt2-small-test").config)


def test_import_bert_matches_jax_and_hf(hf_bert):
    spec = tcreate("bert", vocab=99, n_layers=2, d_model=64, n_heads=4,
                   d_ff=128, max_seq=64, seq_len=24)
    params = _both(tiw.import_bert, jiw.import_bert, _sd(hf_bert),
                   spec.config)
    ids = np.random.default_rng(2).integers(1, 99, (2, 24))
    ids[1, 15:] = 0
    with torch.no_grad():
        out = hf_bert(input_ids=torch.tensor(ids),
                      attention_mask=torch.tensor((ids > 0).astype(np.int64)))
    ref = np.stack([out.start_logits.numpy(), out.end_logits.numpy()], -1)
    got = spec.apply(params, torch.from_numpy(ids.astype(np.float32)),
                     dtype=torch.float32).numpy()
    np.testing.assert_allclose(got[0], ref[0], atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(got[1, :15], ref[1, :15], atol=2e-4,
                               rtol=2e-4)


def test_import_llama_matches_jax_and_hf(hf_llama, tmp_path):
    hf_llama.save_pretrained(str(tmp_path))
    kw = tiw.hf_spec_kwargs(str(tmp_path))
    assert kw == jiw.hf_spec_kwargs(str(tmp_path))
    assert kw["rope_theta"] == 50000.0 and kw["n_kv_heads"] == 2
    spec = tcreate("llama", **kw)
    params = _both(tiw.import_llama, jiw.import_llama,
                   _sd(hf_llama), spec.config)
    tokens = np.random.default_rng(3).integers(0, 101, (2, 11))
    with torch.no_grad():
        ref = hf_llama(torch.tensor(tokens)).logits.numpy()
    got = transformer_apply(params, torch.from_numpy(tokens), spec.config,
                            dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-4)
    loaded = tiw.load_pretrained("llama", str(tmp_path), device="cpu",
                                 dtype="float32")
    _tree_equal(loaded, params)


def test_import_resnet50_v1_matches_jax(hf_resnet):
    _both(tiw.import_resnet50_v1, jiw.import_resnet50_v1,
          _sd(hf_resnet), None)


def test_onnx_initializers_match_jax(tmp_path):
    inits = {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
             "shape": np.asarray([7, -1], np.int64),
             "d": np.asarray([0.5, 1.5], np.float64)}
    p = tmp_path / "inits.onnx"
    p.write_bytes(ow.model([ow.node("Identity", ["input"], ["output"])],
                           inits, ow.value_info("input", ["N", 2]),
                           ow.value_info("output", ["N", 2])))
    got, want = (tiw.load_onnx_initializers(str(p)),
                 jiw.load_onnx_initializers(str(p)))
    _tree_equal(got, want)
    assert got["shape"].dtype == np.int64


@pytest.mark.parametrize("name", ["gpt2", "gpt2-small-test", "bert",
                                  "bert-small-test", "llama", "mistral",
                                  "resnet50-v1", "gpt2-moe", "mlp",
                                  "resnet50", "yolov8n"])
def test_importer_dispatch_matches_jax(name):
    got, want = tiw.importer_for(name), jiw.importer_for(name)
    assert (got is None) == (want is None)


@pytest.mark.parametrize("model_type", ["gpt2", "bert", "llama", "resnet",
                                        "mistral", "t5"])
def test_hf_config_resolution_matches_jax(tmp_path, model_type):
    cfg = {"model_type": model_type, "vocab_size": 50, "n_layer": 2,
           "n_embd": 32, "n_head": 2, "n_positions": 64,
           "num_hidden_layers": 2, "hidden_size": 32,
           "num_attention_heads": 2, "intermediate_size": 64,
           "max_position_embeddings": 64, "sliding_window": None}
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    assert tiw.model_name_from_hf(str(tmp_path)) == \
        jiw.model_name_from_hf(str(tmp_path))
    assert tiw.hf_spec_kwargs(str(tmp_path)) == \
        jiw.hf_spec_kwargs(str(tmp_path))
    assert tiw.model_name_from_hf(str(tmp_path / "nothing")) is None


# -- serving ------------------------------------------------------------------

def _gpt2_golden(model, prompt):
    """HF's logits after ``prompt``: causal, so the engine's zero padding
    after the prompt does not change them."""
    with torch.no_grad():
        return model(torch.tensor([prompt])).logits.numpy()[0, -1]


def test_worker_serves_hf_checkpoints(tmp_path, hf_gpt2):
    """An HF directory as model_path serves at its config.json's geometry
    with its weights: /infer answers HF's logits and a greedy /generate
    starts with HF's argmax. A checkpoint file carries no geometry: the
    registry model's must match it. Another directory refuses by name."""
    d = tmp_path / "hf"
    hf_gpt2.save_pretrained(str(d))
    prompt = [5, 9, 3]
    w = WorkerNode(WorkerConfig(model="gpt2", model_path=str(d),
                                dtype="float32", device="cpu"))
    try:
        assert w.engine.spec.config.n_layers == 3
        got = w.handle_infer({"request_id": "r",
                              "input_data": [float(t) for t in prompt]})
        gen = w.handle_generate({"request_id": "g", "prompt_tokens": prompt,
                                 "max_new_tokens": 4})["tokens"]
    finally:
        w.stop()
    want = _gpt2_golden(hf_gpt2, prompt)
    np.testing.assert_allclose(got["output_data"], want, atol=2e-4,
                               rtol=2e-4)
    assert gen[0] == int(np.argmax(want))
    torch.save(hf_gpt2.state_dict(), tmp_path / "w.bin")
    with pytest.raises(ValueError, match="n_layers"):
        WorkerNode(WorkerConfig(model="gpt2", model_path=str(
            tmp_path / "w.bin"), dtype="float32", device="cpu"))
    orbax = tmp_path / "orbax"
    orbax.mkdir()
    (orbax / "checkpoint").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="orbax"):
        WorkerNode(WorkerConfig(model="gpt2-small-test",
                                model_path=str(orbax), device="cpu"))


def test_import_weights_command_round_trips_through_worker_node(
        tmp_path, hf_gpt2, capsys):
    src = tmp_path / "hf"
    hf_gpt2.save_pretrained(str(src))
    out = tmp_path / "ckpt"
    assert cli.main(["import-weights", "--model", "gpt2", "--src", str(src),
                     "--out", str(out), "--device", "cpu"]) == 0
    assert "imported" in capsys.readouterr().out
    a, node, model, path = cli.worker_node_args(
        ["8001", "w1", str(out), "--device", "cpu", "--dtype", "float32"])
    assert (model, path) == ("gpt2", str(out))
    w = WorkerNode(WorkerConfig(node_id=node, model=model, model_path=path,
                                device=a.device, dtype=a.dtype))
    try:
        prompt = [4, 8, 15]
        got = w.handle_infer({"request_id": "r",
                              "input_data": [float(t) for t in prompt]})
        np.testing.assert_allclose(got["output_data"],
                                   _gpt2_golden(hf_gpt2, prompt), atol=2e-4,
                                   rtol=2e-4)
    finally:
        w.stop()
    a, node, model, path = cli.worker_node_args(["8002", "w2", str(src)])
    assert (model, path) == ("gpt2", str(src))
