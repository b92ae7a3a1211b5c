"""Ring and Ulysses attention of the port (``tpu_engine_torch.parallel.ring``)
against the JAX package's on the same numpy inputs.

JAX runs on the conftest's 8 virtual CPU devices, the port on
``Mesh(["cpu"] * n, ...)``. Every test of ``tests/test_ring_attention.py``
has its counterpart here, with JAX's tolerances (f32 1e-5, bf16 0.05,
the model-level forwards 2e-4): the plain ring (JAX's ``_online_block``
transcribed), Ulysses, masks, fully masked rows, a ``data`` x ``seq``
mesh, placed inputs, the transformer forwards with the ring as their
attention. The card's path (one flash forward a hop, merged by lse) is
held against JAX's ring with the flash forward's plain version as the
hop's block. Also: JAX's error messages, the merged ring's refusal of
inputs that require grad, the plain ring's gradients against JAX's, and
the AST scan of the new modules.
"""

import ast
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_engine.models.transformer import (
    TransformerConfig as JConfig,
    transformer_apply as jtransformer_apply,
    transformer_init as jtransformer_init,
)
from tpu_engine.parallel.mesh import create_mesh as jcreate_mesh
from tpu_engine.parallel.ring import (
    ring_attention as jring,
    seq_sharding as jseq_sharding,
    ulysses_attention as julysses,
)
from tpu_engine_torch.models import convert
from tpu_engine_torch.models.transformer import (
    TransformerConfig,
    transformer_apply,
)
from tpu_engine_torch.ops.flash import flash_attention_reference
from tpu_engine_torch.parallel import ring
from tpu_engine_torch.parallel.mesh import Mesh, MeshTree, Sharding, place

REPO = Path(__file__).resolve().parents[1]
F32_TOL = 1e-5
BF16_TOL = 0.05
MODEL_TOL = 2e-4


def _qkv(seed, b=2, s=32, h=4, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _mask(b, s, valid):
    return np.concatenate([np.ones((b, valid), np.int32),
                           np.zeros((b, s - valid), np.int32)], axis=1)


@pytest.fixture(scope="module")
def jmesh():
    return jcreate_mesh((8,), ("seq",))


@pytest.fixture(scope="module")
def tmesh():
    return Mesh(["cpu"] * 8, (8,), ("seq",))


def _t(x, dtype=torch.float32):
    return None if x is None else torch.from_numpy(np.asarray(x)).to(
        dtype if x.dtype != np.int32 else torch.int32)


def _j(x, dtype=jnp.float32):
    return None if x is None else jnp.asarray(
        x, dtype if x.dtype != np.int32 else jnp.int32)


def _np(x):
    return np.asarray(torch.as_tensor(x).float())


# -- tests/test_ring_attention.py, each with its counterpart --------------------

@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(jmesh, tmesh, causal):
    q, k, v = _qkv(0)
    want = jring(_j(q), _j(k), _j(v), jmesh, causal=causal)
    got = ring.ring_attention(_t(q), _t(k), _t(v), tmesh, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("causal,valid", [(False, 20), (True, 24)],
                         ids=["mask", "causal+mask"])
def test_ring_with_padding_mask_matches_jax(jmesh, tmesh, causal, valid):
    q, k, v = _qkv(1)
    mask = _mask(2, 32, valid)
    want = jring(_j(q), _j(k), _j(v), jmesh, causal=causal,
                 kv_mask=_j(mask))
    got = ring.ring_attention(_t(q), _t(k), _t(v), tmesh, causal=causal,
                              kv_mask=_t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ring_bf16_io_f32_accumulate(jmesh, tmesh):
    q, k, v = _qkv(3)
    want = jring(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                 _j(v, jnp.bfloat16), jmesh, causal=True)
    got = ring.ring_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), tmesh, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_ring_with_placed_inputs_returns_them_placed(jmesh, tmesh):
    """JAX's serving/training path: inputs already split over ``seq``; the
    result is split the same way (JAX: ``out.sharding`` equals the
    inputs')."""
    q, k, v = _qkv(4)
    sh = jseq_sharding(jmesh)
    want = jring(*(jax.device_put(_j(t), sh) for t in (q, k, v)), jmesh,
                 causal=True)
    tsh = ring.seq_sharding(tmesh)
    assert tsh == Sharding(tmesh, "seq", 1)
    placed = [place(_t(t), tsh) for t in (q, k, v)]
    out = ring.ring_attention(*placed, tmesh, causal=True)
    assert isinstance(out, MeshTree) and out.shardings == [tsh]
    for r in range(8):
        assert tuple(out.ranks[r][0].shape) == (2, 4, 4, 8)
    got = Mesh.gather([out.ranks[r][0] for r in range(8)], 1, "cpu")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ring_fully_masked_rows_are_zero(jmesh, tmesh):
    q, k, v = _qkv(5)
    mask = np.zeros((2, 32), np.int32)
    want = np.asarray(jring(_j(q), _j(k), _j(v), jmesh, kv_mask=_j(mask)))
    got = _np(ring.ring_attention(_t(q), _t(k), _t(v), tmesh,
                                  kv_mask=_t(mask)))
    assert not np.isnan(got).any() and not np.isnan(want).any()
    assert (got == 0).all()
    np.testing.assert_allclose(got, want, atol=F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(jmesh, tmesh, causal):
    q, k, v = _qkv(6, h=8)
    want = julysses(_j(q), _j(k), _j(v), jmesh, causal=causal)
    got = ring.ulysses_attention(_t(q), _t(k), _t(v), tmesh, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_ulysses_with_padding_mask_matches_jax(jmesh, tmesh):
    q, k, v = _qkv(7, h=8)
    mask = _mask(2, 32, 17)
    want = julysses(_j(q), _j(k), _j(v), jmesh, kv_mask=_j(mask))
    got = ring.ulysses_attention(_t(q), _t(k), _t(v), tmesh,
                                 kv_mask=_t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_composes_with_data_parallel_axis(fn):
    """A 2-axis mesh: B on ``data``, each slice its own ring on ``seq``."""
    jm = jcreate_mesh((2, 4), ("data", "seq"))
    tm = Mesh(["cpu"] * 8, (2, 4), ("data", "seq"))
    q, k, v = _qkv(8, b=4)
    jfn, tfn = ((jring, ring.ring_attention) if fn == "ring"
                else (julysses, ring.ulysses_attention))
    want = jfn(_j(q), _j(k), _j(v), jm, causal=True, batch_axis="data")
    got = tfn(_t(q), _t(k), _t(v), tm, causal=True, batch_axis="data")
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)
    assert ring.seq_sharding(tm, batch_axis="data") == (
        Sharding(tm, "data", 0), Sharding(tm, "seq", 1))
    assert tuple(jseq_sharding(jm, batch_axis="data").spec) == (
        "data", "seq", None, None)


def _message(fn, *args, **kw) -> str:
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_ring_rejects_indivisible_seq_with_jax_message(jmesh, tmesh):
    q, k, v = _qkv(9, s=30)
    want = _message(jring, _j(q), _j(k), _j(v), jmesh)
    assert want == "seq len 30 not divisible by seq=8"
    assert _message(ring.ring_attention, _t(q), _t(k), _t(v), tmesh) == want


@pytest.mark.parametrize("s,h", [(32, 6), (30, 8)], ids=["heads", "seq"])
def test_ulysses_rejects_indivisible_with_jax_message(jmesh, tmesh, s, h):
    q, k, v = _qkv(10, s=s, h=h)
    want = _message(julysses, _j(q), _j(k), _j(v), jmesh)
    assert "not divisible by seq=8" in want
    assert _message(ring.ulysses_attention, _t(q), _t(k), _t(v),
                    tmesh) == want


def test_indivisible_batch_slices_refuse():
    tm = Mesh(["cpu"] * 8, (2, 4), ("data", "seq"))
    q, k, v = _qkv(11, b=3)
    assert _message(ring.ring_attention, _t(q), _t(k), _t(v), tm,
                    batch_axis="data") == "batch 3 not divisible by data=2"


# -- the transformer forwards with the ring as attention ------------------------

_GPT = dict(vocab=128, n_layers=2, d_model=32, n_heads=4, d_ff=64,
            max_seq=64, causal=True)
_LLAMA = dict(_GPT, n_kv_heads=2, norm="rmsnorm", pos="rope",
              mlp_act="swiglu")


@pytest.mark.parametrize("fields,seed", [(_GPT, 0), (_LLAMA, 2)],
                         ids=["gpt", "llama"])
@pytest.mark.parametrize("fn", ["ring", "ulysses"])
def test_seq_parallel_transformer_forward_matches_jax(jmesh, tmesh, fields,
                                                      seed, fn):
    """The full forward with sequence-parallel attention inside every
    block (rope applied before it, grouped K/V expanded) against JAX's
    forward with its ring, and against the port's own single-device
    forward. Ulysses splits the 4 heads over a 4-rank ``seq`` axis."""
    if fn == "ulysses":
        jmesh = jcreate_mesh((4,), ("seq",), devices=jax.devices()[:4])
        tmesh = Mesh(["cpu"] * 4, (4,), ("seq",))
    jcfg = JConfig(**fields)
    jp = jax.tree.map(np.asarray, jtransformer_init(
        jax.random.PRNGKey(seed), jcfg))
    cfg = TransformerConfig(**fields)
    tp = convert.params_from_jax(jp, cfg, "cpu", "float32")
    tokens = np.random.default_rng(seed + 1).integers(0, 128, (2, 32))
    jfn = jring if fn == "ring" else julysses
    jattn = functools.partial(jfn, mesh=jmesh, axis_name="seq")
    want = jtransformer_apply(
        jp, jnp.asarray(tokens, jnp.int32), jcfg, dtype=jnp.float32,
        attn_fn=lambda q, k, v, causal, mask: jattn(q, k, v, causal=causal,
                                                    kv_mask=mask))
    tfn = ring.ring_attention if fn == "ring" else ring.ulysses_attention
    got = transformer_apply(
        tp, torch.from_numpy(tokens), cfg, dtype=torch.float32,
        attn_fn=lambda q, k, v, causal, mask: tfn(
            q, k, v, tmesh, causal=causal, kv_mask=mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    single = transformer_apply(tp, torch.from_numpy(tokens), cfg,
                               dtype=torch.float32)
    np.testing.assert_allclose(_np(got), _np(single), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


# -- the card's hop-merge, with the flash forward's plain version ---------------

_MERGE_CASES = {
    "causal": dict(causal=True),
    "mask": dict(valid=20),
    "causal+mask": dict(causal=True, valid=24),
    "fully-masked": dict(valid=0),
    "causal+fully-masked-tail": dict(causal=True, valid=3),
}


@pytest.mark.parametrize("case", list(_MERGE_CASES))
def test_hop_merge_over_the_flash_reference_matches_jax(jmesh, tmesh, case):
    """``merge_hops`` with ``flash_attention_reference`` as the hop (the
    card's path, block for block) against JAX's ring. A row masked in
    every hop gives 0; a causal hop from a later rank is skipped."""
    spec = _MERGE_CASES[case]
    q, k, v = _qkv(12)
    mask = _mask(2, 32, spec["valid"]) if "valid" in spec else None
    causal = spec.get("causal", False)
    want = np.asarray(jring(_j(q), _j(k), _j(v), jmesh, causal=causal,
                            kv_mask=_j(mask)))
    got = _np(ring._ring(_t(q), _t(k), _t(v), tmesh, axis_name="seq",
                         causal=causal, kv_mask=_t(mask), batch_axis=None,
                         block=flash_attention_reference))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    if spec.get("valid") == 0:
        assert (got == 0).all()


def test_hop_merge_counts_causal_hops():
    """Under causal, rank i of n runs i + 1 hops (n(n+1)/2 in all), the
    diagonal one causal and the others unmasked by position."""
    calls = []

    def block(q, k, v, *, causal, mask, out_dtype):
        calls.append(causal)
        return flash_attention_reference(q, k, v, causal=causal, mask=mask,
                                         out_dtype=out_dtype)

    q, k, v = (_t(t) for t in _qkv(13, s=16))
    tm = Mesh(["cpu"] * 4, (4,), ("seq",))
    ring._ring(q, k, v, tm, axis_name="seq", causal=True, kv_mask=None,
               batch_axis=None, block=block)
    assert len(calls) == 10 and calls.count(True) == 4
    calls.clear()
    ring._ring(q, k, v, tm, axis_name="seq", causal=False, kv_mask=None,
               batch_axis=None, block=block)
    assert calls == [False] * 16


def test_hop_merge_with_batch_axis_matches_jax():
    jm = jcreate_mesh((2, 4), ("data", "seq"))
    tm = Mesh(["cpu"] * 8, (2, 4), ("data", "seq"))
    q, k, v = _qkv(14, b=4)
    mask = _mask(4, 32, 27)
    want = jring(_j(q), _j(k), _j(v), jm, causal=True, kv_mask=_j(mask),
                 batch_axis="data")
    got = ring._ring(_t(q), _t(k), _t(v), tm, axis_name="seq", causal=True,
                     kv_mask=_t(mask), batch_axis="data",
                     block=flash_attention_reference)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_hop_merge_refuses_inputs_that_require_grad(tmesh):
    q, k, v = (_t(t).requires_grad_() for t in _qkv(15))
    with pytest.raises(NotImplementedError, match="forward-only"):
        ring._ring(q, k, v, tmesh, axis_name="seq", causal=True,
                   kv_mask=None, batch_axis=None,
                   block=flash_attention_reference)
    with torch.no_grad():
        out = ring._ring(q, k, v, tmesh, axis_name="seq", causal=True,
                         kv_mask=None, batch_axis=None,
                         block=flash_attention_reference)
    assert out.shape == q.shape


def test_plain_ring_gradients_match_jax(jmesh, tmesh):
    """The CPU ring is differentiable through autograd, as JAX's is."""
    q, k, v = _qkv(16)
    mask = _mask(2, 32, 28)
    w = np.random.default_rng(17).standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        out = jring(q, k, v, jmesh, causal=True, kv_mask=_j(mask))
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    ts = [_t(t).requires_grad_() for t in (q, k, v)]
    out = ring.ring_attention(*ts, tmesh, causal=True, kv_mask=_t(mask))
    (out * _t(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=F32_TOL, atol=F32_TOL)


# -- no jax ------------------------------------------------------------------------

SEQPAR_SOURCES = ("parallel/ring.py", "parallel/pipeline.py", "ops/moe.py",
                  "models/transformer.py")


@pytest.mark.parametrize("rel", SEQPAR_SOURCES)
def test_seqpar_sources_import_no_jax(rel):
    path = REPO / "tpu_engine_torch" / rel
    assert path in sorted((REPO / "tpu_engine_torch").rglob("*.py"))
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert [n for n in names if n.split(".")[0] in
            ("jax", "jaxlib", "tpu_engine")] == []
