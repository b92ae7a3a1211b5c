"""The port's mixture-of-experts family (tpu_engine_torch.ops.moe, the MoE
blocks of models.transformer, gpt2-moe and gpt2-moe-test) against the JAX
package's, on the CPU, with the same weights and numpy-seeded inputs:

- ``route`` on JAX's router probabilities gives JAX's dispatch and combine
  tensors bit for bit (top_k 1, 2, 3; capacity factors 0.25, 1.25, 4.0;
  forced ties); ``_dispatch_tensors`` from the logits gives the same
  dispatch and the combine within one f32 ulp of a gate, since the two
  packages' f32 ``exp`` differ in the last bit on some inputs;
- ``moe_apply`` in f32 within 1e-5, plain and int8; in bf16 within 2e-2
  of the output's scale on tokens whose router margin exceeds 1e-3;
- the full-sequence forward in f32 within 1e-4 for gpt2-moe-test (no
  drops) and a drop-prone config built in both packages (DROP: 4
  experts, top-2, capacity factor 1.25); DROP's serving forwards with
  padding and free rows BEFORE live ones, whose capacity slots the live
  tokens share;
- ``ContinuousGenerator`` streams (greedy and seeded at temperature 0.8)
  token-identical to JAX's in the dense, two-path, mixed, mixed spec_k 2
  and mixed int8-KV modes, each stream alone (the same composition);
- the worker's /generate, /infer and /score bodies, three train steps,
  and the converter on MoE trees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models import transformer as jt
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.ops import moe as jmoe
from tpu_engine.ops import quant as jquant
from tpu_engine.ops.attention import KVCache as JKV
from tpu_engine.runtime.scheduler import ContinuousGenerator as JaxGen
from tpu_engine_torch.models import convert, transformer as tt
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import moe as tmoe
from tpu_engine_torch.ops import quant as tquant
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator

_ensure_builtin_models_imported()

F32_TOL = 1e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
MARGIN = 1e-3
# One f32 ulp of a gate (gates are at most 1).
GATE_ULP = 2 ** -23
# The drop-prone config: gpt2-moe's routing (top-2, capacity 1.25) at
# gpt2-moe-test's size, 4 experts.
DROP = dict(vocab=256, n_layers=2, d_model=64, n_heads=4, d_ff=128,
            max_seq=128, n_experts=4, top_k=2, capacity_factor=1.25,
            seq_len=16)
CONFIGS = {"gpt2-moe-test": ("gpt2-moe-test", dict(max_seq=128)),
           "drop": ("gpt2-moe", DROP)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe_params(cfg, seed=0):
    """JAX moe_init weights (numpy) and the same as port tensors."""
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                cfg))
    tp = {"gate": {"kernel": _t(jp["gate"]["kernel"])},
          "wi": _t(jp["wi"]), "wo": _t(jp["wo"])}
    return jp, tp


def _tcfg(cfg):
    return tmoe.MoEConfig(**dataclasses.asdict(cfg))


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0])
@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("ties", [False, True])
def test_dispatch_tensors_match_jax(cf, top_k, ties):
    cfg = jmoe.MoEConfig(d_model=8, d_ff=16, n_experts=4, top_k=top_k,
                         capacity_factor=cf)
    rng = np.random.default_rng(top_k * 10 + int(cf * 4))
    n = 48
    logits = (rng.standard_normal((n, 4)) * 2).astype(np.float32)
    if ties:
        # Equal logits: whole rows, a tied pair, a tied top-2 with a
        # zero-probability tail.
        logits[::3] = 0.5
        logits[1::3, 1:3] = 1.25
        logits[2::6, :2] = 3.0
        logits[2::6, 2:] = -200.0
    jd, jc = jmoe._dispatch_tensors(jnp.asarray(logits), cfg, n)
    jd, jc = np.asarray(jd), np.asarray(jc)
    assert jd.shape == (n, 4, cfg.capacity(n))
    td, tc = tmoe._dispatch_tensors(_t(logits), _tcfg(cfg), n)
    np.testing.assert_array_equal(td.numpy(), jd)
    assert np.abs(tc.numpy() - jc).max() <= GATE_ULP
    # From JAX's own probabilities the rest of the routing is bit-equal.
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    rd, rc = tmoe.route(_t(probs), _tcfg(cfg), n)
    np.testing.assert_array_equal(rd.numpy(), jd)
    np.testing.assert_array_equal(rc.numpy(), jc)
    # Every kept pair has one slot; drops happen only under capacity.
    assert jd.sum(axis=(1, 2)).max() <= top_k


@pytest.mark.parametrize("cf", [0.25, 1.25, 4.0, 1.0])
def test_capacity_matches_jax(cf):
    for n in (1, 7, 8, 16, 100, 2048):
        for e, k in ((4, 2), (8, 2), (3, 1), (8, 3)):
            jc = jmoe.MoEConfig(8, 16, e, k, cf)
            assert tmoe.MoEConfig(8, 16, e, k, cf).capacity(n) == \
                jc.capacity(n)


def test_moe_capacity_drops_overflow():
    """A capacity factor small enough drops tokens (their FFN output is 0),
    never an error or a shape change."""
    cfg = tmoe.MoEConfig(d_model=8, d_ff=16, n_experts=2, top_k=1,
                         capacity_factor=0.25)
    g = torch.Generator().manual_seed(0)
    params = tmoe.moe_init(cfg, g, "cpu")
    x = torch.randn((1, 16, 8), generator=g)
    y = tmoe.moe_apply(params, x, cfg, dtype=torch.float32)
    assert y.shape == x.shape
    # capacity = max(1, 0.25 * 1 * 16 / 2) = 2 slots an expert: at most 4
    # tokens served.
    norms = torch.linalg.norm(y[0], dim=-1)
    assert int((norms < 1e-6).sum()) >= 16 - 4


# -- moe_apply ------------------------------------------------------------------

def _x(b=2, t=16, d=64, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


@pytest.mark.parametrize("cf", [1.25, 4.0])
@pytest.mark.parametrize("int8", [False, True])
def test_moe_apply_f32_matches_jax(cf, int8):
    cfg = jmoe.MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                         capacity_factor=cf)
    jp, tp = _moe_params(cfg)
    if int8:
        jp = jax.tree.map(np.asarray, jquant.quantize_params(jp))
        tp = tquant.quantize_params(tp)
        for k in ("wi_q", "wi_scale", "wo_q", "wo_scale"):
            np.testing.assert_array_equal(tp[k].numpy(), jp[k])
        assert tp["gate"]["kernel"].dtype == torch.float32
    x = _x()
    want = np.asarray(jmoe.moe_apply(jp, jnp.asarray(x), cfg,
                                     dtype=jnp.float32))
    got = tmoe.moe_apply(tp, _t(x), _tcfg(cfg), dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                               rtol=F32_TOL)


def _router_margin(probs, k):
    """Per token, the smallest gap between consecutive sorted
    probabilities among the top k + 1: a choice or a rank that another
    rounding could flip."""
    s = -np.sort(-probs, axis=-1)[:, :k + 1]
    return (s[:, :-1] - s[:, 1:]).min(axis=-1)


@pytest.mark.parametrize("int8", [False, True])
def test_moe_apply_bf16_matches_jax_on_margin_tokens(int8):
    cfg = jmoe.MoEConfig(d_model=64, d_ff=128, n_experts=4, top_k=2,
                         capacity_factor=4.0)
    jp, tp = _moe_params(cfg, seed=1)
    if int8:
        jp = jax.tree.map(np.asarray, jquant.quantize_params(jp))
        tp = tquant.quantize_params(tp)
    x = _x(seed=4)
    want = np.asarray(jmoe.moe_apply(jp, jnp.asarray(x), cfg,
                                     dtype=jnp.bfloat16))
    got = tmoe.moe_apply(tp, _t(x), _tcfg(cfg), dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    logits = np.asarray(jax.nn.softmax(
        (jnp.asarray(x).reshape(-1, 64).astype(jnp.bfloat16)
         @ jnp.asarray(jp["gate"]["kernel"]).astype(jnp.bfloat16)
         ).astype(jnp.float32), axis=-1))
    keep = _router_margin(logits, cfg.top_k) > MARGIN
    assert keep.mean() > 0.8
    diff = np.abs(got.numpy().reshape(-1, 64) - want.reshape(-1, 64))
    scale = max(1.0, float(np.abs(want).max()))
    assert diff[keep].max() <= BF16_TOL * scale


# -- models ---------------------------------------------------------------------

_MODELS = {}


def _models(key):
    """(JAX spec, JAX params, port spec, port params f32) of a CONFIGS
    entry, built once."""
    if key not in _MODELS:
        name, kw = CONFIGS[key]
        js = jcreate(name, **kw)
        jp = js.init(jax.random.PRNGKey(0))
        ts = tcreate(name, **kw)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                     ts.config, device="cpu")
        _MODELS[key] = (js, jp, ts, tp)
    return _MODELS[key]


@pytest.mark.parametrize("name", ["gpt2-moe", "gpt2-moe-test"])
def test_config_fields_equal_jax(name):
    jcfg, tcfg = jcreate(name).config, tcreate(name).config
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
    assert tcreate(name).input_shape == jcreate(name).input_shape
    assert tcreate(name).state_family == jcreate(name).state_family
    assert tcreate(name).capabilities == jcreate(name).capabilities


class _Drops:
    """Counts the (token, choice) pairs every routing of a forward drops."""

    def __init__(self, monkeypatch):
        self.dropped = self.pairs = 0
        route = tmoe.route

        def counted(probs, cfg, n_tokens):
            d, c = route(probs, cfg, n_tokens)
            self.pairs += probs.shape[0] * cfg.top_k
            self.dropped += probs.shape[0] * cfg.top_k - int(d.sum())
            return d, c

        monkeypatch.setattr(tmoe, "route", counted)


@pytest.mark.parametrize("key", list(CONFIGS))
def test_transformer_apply_matches_jax(key, monkeypatch):
    js, jp, ts, tp = _models(key)
    tokens = np.random.default_rng(5).integers(
        1, js.config.vocab, (2, 32)).astype(np.int32)
    want = np.asarray(jt.transformer_apply(jp, jnp.asarray(tokens),
                                           js.config, dtype=jnp.float32))
    drops = _Drops(monkeypatch)
    got = tt.transformer_apply(tp, _t(tokens), ts.config,
                               dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    # gpt2-moe-test drops nothing (capacity factor 4); DROP drops.
    assert (drops.dropped > 0) == (key == "drop"), drops.dropped


def test_step_rows_ragged_padding_first_matches_jax(monkeypatch):
    """DROP's mixed step with rows whose padding slots come BEFORE later
    rows' live tokens in token order: they share the capacity slots, so
    the live logits match JAX's only if the padding does. Every column a
    slot reaches maps to a real block: a slot that reads the null block
    reads whichever padding write landed there last, which JAX leaves
    unspecified (XLA's order changes with the CPU device count)."""
    js, jp, ts, tp = _models("drop")
    cfg = js.config
    rng = np.random.default_rng(6)
    shape = (cfg.n_layers, 17, 16, cfg.kv_heads, cfg.d_head)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    w = 20
    tokens = rng.integers(0, cfg.vocab, (4, w)).astype(np.int32)
    tables = np.arange(1, 17, dtype=np.int32).reshape(4, 4)
    pos0 = np.array([5, 20, 10, 30], np.int32)
    qlen = np.array([1, 3, 20, 5], np.int32)
    jl, jc = jt.transformer_step_rows_ragged(
        jp, jnp.asarray(tokens), JKV(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tables), jnp.asarray(pos0), jnp.asarray(qlen), cfg,
        dtype=jnp.float32)
    drops = _Drops(monkeypatch)
    tl, tc = tt.transformer_step_rows_ragged(
        tp, _t(tokens), tt.KVCache(_t(k0), _t(v0)), _t(tables), _t(pos0),
        _t(qlen), ts.config, dtype=torch.float32)
    assert drops.dropped > 0
    valid = np.arange(w)[None, :] < qlen[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    np.testing.assert_allclose(tc.k.numpy()[:, 1:], np.asarray(jc.k)[:, 1:],
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_decode_forwards_free_row_first_match_jax():
    """DROP's paged and dense decode steps with a free row first."""
    js, jp, ts, tp = _models("drop")
    cfg = js.config
    rng = np.random.default_rng(7)
    shape = (cfg.n_layers, 12, 16, cfg.kv_heads, cfg.d_head)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    tok = rng.integers(0, cfg.vocab, (4,)).astype(np.int32)
    tables = np.array([[0, 0, 0], [1, 2, 0], [3, 4, 5], [6, 0, 0]],
                      np.int32)
    pos = np.array([0, 16, 40, 5], np.int32)
    jl, _ = jt.transformer_decode_rows_paged(
        jp, jnp.asarray(tok), JKV(jnp.asarray(k0), jnp.asarray(v0)),
        jnp.asarray(tables), jnp.asarray(pos), cfg, dtype=jnp.float32)
    tl, _ = tt.transformer_decode_rows_paged(
        tp, _t(tok), tt.KVCache(_t(k0), _t(v0)), _t(tables), _t(pos),
        ts.config, dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy()[1:], np.asarray(jl)[1:],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    dense = rng.standard_normal((cfg.n_layers, 4, 48, cfg.kv_heads,
                                 cfg.d_head)).astype(np.float32)
    start = np.array([0, 0, 3, 10], np.int32)
    jl, jc = jt.transformer_decode_rows(
        jp, jnp.asarray(tok), JKV(jnp.asarray(dense), jnp.asarray(dense)),
        jnp.asarray(pos), cfg, dtype=jnp.float32,
        start_vec=jnp.asarray(start))
    tc = tt.KVCache(_t(dense), _t(dense))
    tl, _ = tt.transformer_decode_rows(tp, _t(tok), tc, _t(pos), ts.config,
                                       dtype=torch.float32,
                                       start_vec=_t(start))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                               atol=MODEL_TOL, rtol=MODEL_TOL)


def test_left_padded_prefill_and_windows_match_jax(monkeypatch):
    """DROP's dense prefill of a left-padded batch (pad tokens before the
    prompts, in every row) and the two-path prefill windows."""
    js, jp, ts, tp = _models("drop")
    cfg = js.config
    rng = np.random.default_rng(8)
    pb, lens = 32, (19, 32)
    tokens = np.zeros((2, pb), np.int32)
    attn = np.zeros((2, pb), np.int32)
    pos_ids = np.zeros((2, pb), np.int32)
    for r, n in enumerate(lens):
        tokens[r, pb - n:] = rng.integers(1, cfg.vocab, n)
        attn[r, pb - n:] = 1
        pos_ids[r, pb - n:] = np.arange(n)
    jl, jc = jt.transformer_prefill(
        jp, jnp.asarray(tokens), jt.init_caches(cfg, 2, 48, jnp.float32),
        cfg, dtype=jnp.float32, attn_mask=jnp.asarray(attn),
        pos_ids=jnp.asarray(pos_ids))
    drops = _Drops(monkeypatch)
    tc = tt.init_caches(ts.config, 2, 48, torch.float32, device="cpu")
    tl, _ = tt.transformer_prefill(
        tp, _t(tokens), tc, ts.config, dtype=torch.float32,
        attn_mask=_t(attn), pos_ids=_t(pos_ids))
    assert drops.dropped > 0
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=MODEL_TOL,
                               rtol=MODEL_TOL)
    valid = attn.astype(bool)
    np.testing.assert_allclose(tc.k.numpy()[:, :, :pb][:, valid],
                               np.asarray(jc.k)[:, :, :pb][:, valid],
                               atol=MODEL_TOL, rtol=MODEL_TOL)
    jc = jt.init_caches(cfg, 2, pb, jnp.float32)
    tc = tt.init_caches(ts.config, 2, pb, torch.float32, device="cpu")
    start = np.array([0, 3], np.int32)
    for w0 in (0, 12, 24):
        width = min(12, pb - w0)
        pos = np.full((2,), w0, np.int32)
        jl, jc = jt.transformer_decode_window(
            jp, jnp.asarray(tokens[:, w0:w0 + width]), jc, jnp.asarray(pos),
            cfg, dtype=jnp.float32, start_vec=jnp.asarray(start))
        tl, _ = tt.transformer_decode_window(
            tp, _t(tokens[:, w0:w0 + width]), tc, _t(pos), ts.config,
            dtype=torch.float32, start_vec=_t(start))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)


# -- the continuous scheduler ---------------------------------------------------

LANE = dict(dtype="float32", n_slots=4, max_seq=128, prefill_chunk=16,
            step_chunk=4)
PAGED = dict(kv_block_size=16)
MIXED = dict(PAGED, mixed_step=True, mixed_token_budget=16)
MODES = {"dense": {}, "two-path": PAGED, "mixed": MIXED,
         "mixed-spec": dict(MIXED, spec_k=2),
         "mixed-int8": dict(MIXED, kv_quantize="int8")}
PROMPTS = [[5, 9, 3], [(i * 7) % 90 + 1 for i in range(40)], [7, 2],
           [(i * 3) % 90 + 1 for i in range(15)]]


@pytest.fixture(scope="module")
def lanes():
    built = {}

    def get(key, mode):
        if (key, mode) not in built:
            js, jp, ts, tp = _models(key)
            kw = dict(LANE, **MODES[mode])
            built[key, mode] = (JaxGen(js, params=jp, **kw),
                                ContinuousGenerator(ts, params=tp,
                                                    device="cpu", **kw))
        return built[key, mode]
    yield get
    for pair in built.values():
        for g in pair:
            g.stop()


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("key", list(CONFIGS))
def test_streams_match_jax(lanes, key, mode, temperature):
    """Each prompt alone, so both lanes tick the same compositions."""
    jg, tg = lanes(key, mode)
    for prompt in PROMPTS:
        want = jg.generate([prompt], max_new_tokens=8,
                           temperature=temperature, seed=7)
        got = tg.generate([prompt], max_new_tokens=8,
                          temperature=temperature, seed=7)
        assert got == want, (prompt, got, want)
    st = tg.stats()
    if "mixed" in st:
        assert st["mixed"]["ticks"] == st["mixed"]["dispatches"] > 0


# -- the worker ---------------------------------------------------------------

def test_worker_bodies_match_jax():
    from tpu_engine.runtime.engine import InferenceEngine as JaxEngine
    from tpu_engine.serving.worker import WorkerNode as JaxWorker
    from tpu_engine.utils.config import WorkerConfig as JaxConfig
    from tpu_engine_torch.serving.worker import WorkerNode
    from tpu_engine_torch.utils.config import WorkerConfig

    js, jp, ts, tp = _models("gpt2-moe-test")
    lane = dict(gen_kv_block_size=16, gen_prefill_chunk=16,
                gen_mixed_step=True, gen_mixed_token_budget=16)
    w = WorkerNode(WorkerConfig(node_id="m0", model="gpt2-moe-test",
                                dtype="float32", device="cpu", **lane),
                   params=tp)
    jw = JaxWorker(JaxConfig(node_id="m0", model="gpt2-moe-test",
                             dtype="float32", **lane),
                   engine=JaxEngine(js, jp, dtype="float32"))
    try:
        req = {"request_id": "g1", "prompt_tokens": [5, 9, 3, 17],
               "max_new_tokens": 6}
        assert w.handle_generate(dict(req))["tokens"] == \
            jw.handle_generate(dict(req))["tokens"]
        x = [5.0, 9.0, 3.0, 17.0, 2.0] + [0.0] * 11
        ti = w.handle_infer({"request_id": "i1", "input_data": x})
        ji = jw.handle_infer({"request_id": "i1", "input_data": x})
        np.testing.assert_allclose(ti["output_data"], ji["output_data"],
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        body = {"request_id": "s1", "prompt_tokens": [3, 4, 8],
                "completion_tokens": [5, 6]}
        ts_, js_ = w.handle_score(dict(body)), jw.handle_score(dict(body))
        assert set(ts_) == set(js_)
        np.testing.assert_allclose(ts_["logprobs"], js_["logprobs"],
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
    finally:
        w.stop()
        jw.stop()


# -- training and the converter ---------------------------------------------

def test_train_steps_match_jax():
    """Three AdamW steps (lr 1e-3) of gpt2-moe-test in f32 in both
    packages: losses within 1e-4 relative, as the train tests bound
    them."""
    import optax

    from tpu_engine.training import train as jtrain
    from tpu_engine_torch.training import train as ttrain

    js, jp, ts, tp = _models("gpt2-moe-test")
    jinit, jstep = jtrain.make_train_step(
        lambda p, x, dtype=jnp.float32: jt.transformer_apply(
            p, x, js.config, dtype=dtype),
        loss_fn=jtrain.cross_entropy_loss, optimizer=optax.adamw(1e-3),
        dtype=jnp.float32)
    tinit, tstep = ttrain.make_train_step(
        lambda p, x, dtype=torch.float32: tt.transformer_apply(
            p, x, ts.config, dtype=dtype),
        loss_fn=ttrain.cross_entropy_loss, optimizer=ttrain.adamw(1e-3),
        dtype=torch.float32)
    jstep = jax.jit(jstep)
    jstate = jinit(jp)
    tstate = tinit(ttrain.tree_map(torch.clone, tp))
    for i in range(3):
        tok = np.random.default_rng(i).integers(
            1, js.config.vocab, (2, 25)).astype(np.int32)
        x, y = tok[:, :-1], tok[:, 1:]
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tloss = tstep(tstate, _t(x), _t(y))
        assert abs(float(tloss) - float(jloss)) <= MODEL_TOL * abs(
            float(jloss))
    assert tstate.step == int(jstate.step) == 3
    # A JAX run's MoE state carries across and continues.
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                         ts.config, device="cpu")
    tok = np.random.default_rng(3).integers(
        1, js.config.vocab, (2, 25)).astype(np.int32)
    jstate, jloss = jstep(jstate, jnp.asarray(tok[:, :-1]),
                          jnp.asarray(tok[:, 1:]))
    state, loss = tstep(state, _t(tok[:, :-1]), _t(tok[:, 1:]))
    assert abs(float(loss) - float(jloss)) <= MODEL_TOL * abs(float(jloss))
    assert state.step == 4


def test_train_command_trains_moe(capsys):
    from tpu_engine_torch.serving import cli

    rc = cli.train(["--model", "gpt2-moe-test", "--steps", "8", "--batch",
                    "4", "--seq", "16", "--log-every", "4", "--device",
                    "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    losses = [float(ln.split()[-1]) for ln in out.splitlines()
              if ln.startswith("step ")]
    assert len(losses) >= 2 and losses[-1] < losses[0], out


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in _shapes(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _shapes(v, f"{prefix}/{i}")]
    return [f"{prefix}:{tuple(tree.shape)}"]


def test_converter_carries_moe_trees():
    js, jp, ts, tp = _models("gpt2-moe-test")
    cfg = ts.config
    mlp = tp["blocks"][1]["mlp"]
    assert sorted(mlp) == ["gate", "wi", "wo"]
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert tuple(mlp["wi"].shape) == (e, d, f)
    assert tuple(mlp["wo"].shape) == (e, f, d)
    np.testing.assert_array_equal(mlp["wi"].numpy(),
                                  np.asarray(jp["blocks"]["mlp"]["wi"])[1])
    bf = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu", dtype="bfloat16")
    assert bf["blocks"][0]["mlp"]["wo"].dtype == torch.bfloat16
    assert bf["blocks"][0]["mlp"]["gate"]["kernel"].dtype == torch.bfloat16
    # Quantized trees carry across as they are.
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jp))
    cq = convert.params_from_jax(jq, cfg, device="cpu", dtype="bfloat16")
    qm = cq["blocks"][1]["mlp"]
    assert qm["wi_q"].dtype == torch.int8
    assert qm["wi_scale"].dtype == torch.float32
    np.testing.assert_array_equal(qm["wo_q"].numpy(),
                                  jq["blocks"]["mlp"]["wo_q"][1])
    assert cq["head"]["kernel_q"].dtype == torch.int8
    # init_params draws the same tree as moe_init's, in the serving dtype.
    init = convert.init_params(cfg, seed=1, device="cpu", dtype="bfloat16")
    assert sorted(_shapes(init)) == sorted(_shapes(tp))
    im = init["blocks"][0]["mlp"]
    assert im["wi"].dtype == torch.bfloat16
    assert abs(float(im["wo"].float().std()) - f ** -0.5) < 0.1 * f ** -0.5
    assert abs(float(im["gate"]["kernel"].float().std()) - d ** -0.5) < \
        0.2 * d ** -0.5

