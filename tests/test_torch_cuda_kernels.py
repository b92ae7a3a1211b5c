"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test carries the ``cuda`` marker and skips where no CUDA
device is present (the kernels have no CPU mode). This file imports no
jax, so the card's machine runs it without the JAX package:

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances: 1e-5 with an f32 pool (only the summation order differs);
2e-2 with a bf16 pool on unit-normal inputs (both round the softmax
weights to bf16, the ragged and decode kernels against the maximum of
each split, the plain version against the row's); against the plain
repetition of a split kernel's own arithmetic (``*_split_reference``),
8e-3 for the bf16 decode read, about one bf16 ulp of an output of
magnitude 1-2 (the weights round at the same points; a weight whose f32
value differs in its last bit may round one bf16 ulp apart);
2e-4 with the int8 pool, the JAX package's bound for its int8 kernels
(the kernel applies the K scales after the product, the dense plain
version dequantizes first); 1e-5 for the int8 decode read against its
split plain version (f32 on both sides at the same rounding points, only
the summation order differs; measured at most 3.9e-7 on the card at the
parity and main-path shapes). The flash forward: 1e-5 in f32, 2e-2 in bf16 (both
round the weights to bf16, the kernel against its running maximum, the
plain version against the row's), on out and on lse. The flash backward
(dq; dk and dv): 1e-4 of the gradient's largest magnitude in f32 (f32
sums in another order), 2e-2 in bf16 (p and ds rounded to bf16 from f32
values that differ in their last bits), over cases that cross the
kernels' tiles (ragged tails, a band across tile edges, padding over whole
tiles, strided and misaligned views); also the FlashAttention Function
on the card against the CPU, run-to-run bit identity, and training
gradients of a small llama on the card against the CPU, in f32 and in
bf16. The speculative lanes' shapes: the ragged reads over a spec tick's
verify windows (k 3, 4 and 7; G 1 and 8; one window across the 512-key
split, one across a block edge) against the dense and split plain
versions, bit-identical over two runs and row by row alone; the flash
forward at the draft model's prefill (B 1 x S 64, 20 columns of left
padding). The bert lane's shape: the flash forward non-causal under a
padding mask at B 1 and 32 x S 384 x 12 heads x D 64 with an all-pad row,
and bert-small-test's forward on the card against the CPU (1e-4: f32
sums of two layers in another order)."""

import numpy as np
import pytest
import torch

from tpu_engine_torch.ops import flash as tfl
from tpu_engine_torch.ops import kernels
from tpu_engine_torch.ops import paged_attention as tpa

# (q_lens, n_heads, n_kv_heads): the JAX package's ragged_parity_check and
# spec_verify_parity_check shapes, plus the G = 8 grouping of TinyLlama.
CASES = [((1, 7, 16, 17), 4, 2), ((1, 5, 5, 16, 17), 4, 2),
         ((1, 3, 16, 17), 8, 1)]
# Decode shapes: the JAX package's parity_check defaults and second case,
# and TinyLlama's G = 8 at D 64 with 8-block tables.
DECODE_CASES = [dict(),
                dict(n_heads=8, n_kv_heads=2, d_head=16, block_size=8,
                     n_blocks=17, table_len=6),
                dict(n_heads=16, n_kv_heads=2, d_head=64, n_blocks=33,
                     table_len=8)]
QUANT_TOL = 2e-4
QUANT_SPLIT_TOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _valid_err(out, ref, qlen):
    diff = (out.float() - ref.float()).abs().cpu().numpy()
    valid = np.arange(diff.shape[1])[None, :] < qlen[:, None]
    return float(np.where(valid[:, :, None, None], diff, 0.0).max())


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ragged_kernel_matches_plain(cuda_device, q_lens, h, h_kv, dtype,
                                     tol):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    launches = tpa.ragged_paged_attention.launches
    out = tpa.ragged_paged_attention(*t)
    ref = tpa.ragged_paged_attention_reference(*t)
    torch.cuda.synchronize()
    assert tpa.ragged_paged_attention.launches == launches + 1
    assert out.dtype == dtype
    assert _valid_err(out, ref, arrs[5]) < tol


@pytest.mark.cuda
def test_ragged_kernel_refuses_bad_arguments(cuda_device):
    t = [torch.from_numpy(a).to(cuda_device)
         for a in tpa.ragged_parity_inputs()]
    bad_tables = t[3].long()
    with pytest.raises(ValueError, match="int32"):
        tpa.ragged_paged_attention(t[0], t[1], t[2], bad_tables, t[4], t[5])
    with pytest.raises(ValueError, match="head dim"):
        tpa.ragged_paged_attention(t[0][..., :6].contiguous(),
                                   t[1][..., :6].contiguous(),
                                   t[2][..., :6].contiguous(), *t[3:])
    with pytest.raises(ValueError, match="is on"):
        tpa.ragged_paged_attention(t[0], t[1].cpu(), t[2], *t[3:])


def _on(dev, arrs):
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _launched(fn, call):
    launches, plain = fn.launches, fn.plain_calls
    out = call()
    torch.cuda.synchronize()
    assert fn.launches == launches + 1 and fn.plain_calls == plain
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kw", DECODE_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_matches_plain(cuda_device, kw, dtype, tol):
    t = _on(cuda_device, tpa.parity_inputs(**kw))
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    out = _launched(tpa.paged_attention, lambda: tpa.paged_attention(*t))
    ref = tpa.paged_attention_reference(*t)
    assert out.dtype == dtype
    assert float((out.float() - ref.float()).abs().max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("kw", DECODE_CASES)
def test_quant_paged_kernel_matches_plain(cuda_device, kw):
    t = _on(cuda_device, tpa.parity_inputs(quant=True, **kw))
    out = _launched(tpa.quant_paged_attention,
                    lambda: tpa.quant_paged_attention(*t))
    ref = tpa.quant_paged_attention_reference(*t)
    assert out.dtype == torch.float32
    assert float((out - ref).abs().max()) < QUANT_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("q_lens,h,h_kv", CASES)
def test_quant_ragged_kernel_matches_plain(cuda_device, q_lens, h, h_kv):
    arrs = tpa.ragged_parity_inputs(q_lens=q_lens, n_heads=h,
                                    n_kv_heads=h_kv, quant=True)
    t = _on(cuda_device, arrs)
    out = _launched(tpa.quant_ragged_paged_attention,
                    lambda: tpa.quant_ragged_paged_attention(*t))
    ref = tpa.quant_ragged_paged_attention_reference(*t)
    assert out.dtype == torch.float32
    assert _valid_err(out, ref, arrs[-1]) < QUANT_TOL


@pytest.mark.cuda
def test_slice2_kernels_refuse_bad_arguments(cuda_device):
    t = _on(cuda_device, tpa.parity_inputs())
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_attention(t[0], t[1], t[2], t[3].long(), t[4])
    with pytest.raises(ValueError, match="one query slot"):
        tpa.paged_attention(t[0].repeat(1, 2, 1, 1), *t[1:])
    qt = _on(cuda_device, tpa.parity_inputs(quant=True))
    with pytest.raises(ValueError, match="int8"):
        tpa.quant_paged_attention(qt[0], qt[1].float(), qt[2], *qt[3:])
    with pytest.raises(ValueError, match="k_scale"):
        tpa.quant_paged_attention(qt[0], qt[1], qt[2], qt[3].double(),
                                  *qt[4:])
    rt = _on(cuda_device, tpa.ragged_parity_inputs(quant=True))
    with pytest.raises(ValueError, match="is on"):
        tpa.quant_ragged_paged_attention(rt[0], rt[1], rt[2], rt[3].cpu(),
                                         *rt[4:])
    with pytest.raises(ValueError, match="qlen"):
        tpa.quant_ragged_paged_attention(*rt[:7], rt[7][:2].contiguous())


# name -> (parity_inputs kwargs, causal, valid keys per row or None, window)
FLASH_CASES = {
    "causal": (dict(sq=64), True, None, None),
    "ragged-37-53": (dict(sq=37, sk=53), False, None, None),
    "causal-ragged-200": (dict(sq=200), True, None, None),
    "causal-left-pad": (dict(sq=130), True, (130, 71), None),
    "padding-mask": (dict(sq=64), False, (40, 64), None),
    "fully-masked": (dict(sq=64), False, (0, 0), None),
    "window-7": (dict(sq=200), True, None, 7),
    "window-64-pad": (dict(sq=200), True, (200, 90), 64),
}


def _flash_inputs(dev, case, d, dtype, cases=None):
    kw, causal, valid, window = (cases or FLASH_CASES)[case]
    q, k, v = (torch.from_numpy(a).to(dev, dtype)
               for a in tfl.parity_inputs(d_head=d, seed=d, **kw))
    mask = None
    if valid is not None:
        # Left padding as the dense prefill has it: the valid keys end at
        # the row's last column.
        sk = k.shape[1]
        m = np.zeros((2, sk), np.int32)
        for r, n in enumerate(valid):
            m[r, sk - n:] = 1
        mask = torch.from_numpy(m).to(dev)
    return q, k, v, dict(causal=causal, mask=mask, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("d", tfl.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_matches_plain(cuda_device, case, d, dtype, tol):
    q, k, v, kw = _flash_inputs(cuda_device, case, d, dtype)
    out, lse = _launched(tfl.flash_attention_fwd,
                         lambda: tfl.flash_attention_fwd(q, k, v, **kw))
    ref, ref_lse = tfl.flash_attention_reference(q, k, v, **kw)
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    assert float((out.float() - ref.float()).abs().max()) < tol
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert float(torch.where(dead, 0.0, lse - ref_lse).abs().max()) < tol
    if case == "fully-masked":
        assert float(out.float().abs().max()) == 0.0


@pytest.mark.cuda
def test_flash_kernel_reads_strided_operands(cuda_device):
    """q, k, v as (B, H, S, D) tensors viewed as (B, S, H, D): the kernel
    reads them through their strides, no copy."""
    q, k, v = (torch.from_numpy(a).to(cuda_device).transpose(1, 2)
               .contiguous().transpose(1, 2)
               for a in tfl.parity_inputs(sq=100, d_head=64))
    assert not q.is_contiguous()
    out = _launched(tfl.flash_attention_fwd,
                    lambda: tfl.flash_attention(q, k, v, causal=True))
    ref = tfl.flash_attention_reference(q, k, v, causal=True)[0]
    assert float((out - ref).abs().max()) < 1e-5


@pytest.mark.cuda
def test_flash_kernel_refuses_bad_arguments(cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in tfl.parity_inputs())
    with pytest.raises(ValueError, match="head dim"):
        tfl.flash_attention(q[..., :8], k[..., :8], v[..., :8])
    with pytest.raises(ValueError, match="dtypes"):
        tfl.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="is on"):
        tfl.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="requires causal"):
        tfl.flash_attention(q, k, v, window=4)
    # A launch the library refuses (no batch) raises, it never runs.
    out = torch.empty_like(q)
    lse = torch.empty((2, 4, 64), device=cuda_device)
    with pytest.raises(RuntimeError, match="flash_attention launch failed"):
        kernels.launch("flash_attention", q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
                       lse.data_ptr(), 0, 64, 64, 4, 16,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       1, 0, 0.25, 0)


# The flash backward (#6 dq, #7 dk/dv): the forward's cases plus causal
# with Sq < Sk (keys past the last query get dk = dv = 0), and cases that
# cross the tiling's boundaries: several swept tiles with ragged tails
# (1000; 300 queries against 700 keys), a band crossing tile edges
# (window 200 at 1024), left padding over whole 64-key tiles, and q, k, v
# and do as a (B, H, S, D) tensor viewed as (B, S, H, D) (read through
# strides, no copy) or as views whose rows are not 16-byte aligned (copied
# by the wrapper before the launch).
BWD_CASES = dict(FLASH_CASES, **{
    "causal-ragged-37-100": (dict(sq=37, sk=100), True, None, None),
    "causal-ragged-1000": (dict(sq=1000), True, None, None),
    "causal-300-700": (dict(sq=300, sk=700), True, None, None),
    "window-200-1024": (dict(sq=1024), True, None, 200),
    "left-pad-tiles-300": (dict(sq=300), True, (300, 150), None),
    "transposed-view": (dict(sq=200), True, None, None),
    "misaligned-view": (dict(sq=200), True, (200, 130), None),
})
BWD_VIEWS = {"transposed-view", "misaligned-view"}
BWD_F32_TOL = 1e-4   # max|Δ| / max|ref|: differently ordered f32 sums
BWD_BF16_TOL = 2e-2  # p and ds rounded to bf16 from f32 values that differ


def _view(t, case):
    """t's values as the view ``case`` names."""
    if case == "transposed-view":
        return t.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                       device=t.device)
    wide[..., 1:] = t
    return wide[..., 1:]


def _bwd_inputs(dev, case, d, dtype):
    q, k, v, kw = _flash_inputs(dev, case, d, dtype, BWD_CASES)
    if case in BWD_VIEWS:
        q, k, v = (_view(t, case) for t in (q, k, v))
        aligned = case == "transposed-view"
        assert not q.is_contiguous()
        assert all(tfl._rows_aligned(t) == aligned for t in (q, k, v))
    out, lse = tfl.flash_attention_reference(q, k, v, **kw)
    rng = np.random.default_rng(d + 1)
    do = torch.from_numpy(rng.standard_normal(q.shape, np.float32)).to(
        dev, dtype)
    if case in BWD_VIEWS:
        do = _view(do, case)
    delta = tfl.bwd_delta(do, out)
    return (q, k, v, kw["mask"], lse, delta, do), kw


def _rel_err(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp(min=1e-12))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
@pytest.mark.parametrize("d", tfl.SUPPORTED_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, BWD_F32_TOL),
                                       (torch.bfloat16, BWD_BF16_TOL)])
def test_flash_bwd_kernels_match_plain(cuda_device, case, d, dtype, tol):
    args, kw = _bwd_inputs(cuda_device, case, d, dtype)
    kw = dict(causal=kw["causal"], window=kw["window"])
    dq = _launched(tfl.flash_attention_bwd_dq,
                   lambda: tfl.flash_attention_bwd_dq(*args, **kw))
    dk, dv = _launched(tfl.flash_attention_bwd_dkv,
                       lambda: tfl.flash_attention_bwd_dkv(*args, **kw))
    ref_dq = tfl.flash_attention_bwd_dq_reference(*args, **kw)
    ref_dk, ref_dv = tfl.flash_attention_bwd_dkv_reference(*args, **kw)
    for got, ref in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got.float()).all())
        if float(ref.float().abs().max()) == 0.0:
            assert float(got.float().abs().max()) == 0.0
        else:
            assert _rel_err(got, ref) < tol
    if case == "causal-ragged-37-100":
        assert float(dk[:, 37:].abs().max()) == 0.0
        assert float(dv[:, 37:].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case,dtype", [
    ("causal-left-pad", torch.bfloat16), ("window-200-1024", torch.bfloat16),
    ("window-200-1024", torch.float32)])
def test_flash_bwd_is_bit_identical_across_runs(cuda_device, case, dtype):
    args, kw = _bwd_inputs(cuda_device, case, 64, dtype)
    kw = dict(causal=kw["causal"], window=kw["window"])
    first = (tfl.flash_attention_bwd_dq(*args, **kw),
             *tfl.flash_attention_bwd_dkv(*args, **kw))
    again = (tfl.flash_attention_bwd_dq(*args, **kw),
             *tfl.flash_attention_bwd_dkv(*args, **kw))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal-left-pad", "window-64-pad",
                                  "ragged-37-53"])
def test_flash_function_grads_match_cpu(cuda_device, case):
    """FlashAttention's autograd on the card (forward and both backward
    kernels) against the same inputs through the plain path on the CPU."""
    grads = {}
    for dev in ("cpu", cuda_device):
        q, k, v, kw = _flash_inputs(torch.device(dev), case, 64,
                                    torch.float32)
        t = [x.detach().requires_grad_() for x in (q, k, v)]
        out = tfl.flash_attention(*t, **kw)
        assert out.grad_fn is not None
        w = torch.sin(torch.arange(out.numel(), device=out.device,
                                   dtype=torch.float32).reshape(out.shape))
        (out * w).sum().backward()
        grads[str(dev)] = [x.grad.cpu() for x in t]
    for got, ref in zip(grads[str(cuda_device)], grads["cpu"]):
        assert _rel_err(got, ref) < BWD_F32_TOL


@pytest.mark.cuda
def test_flash_bwd_refuses_bad_arguments(cuda_device):
    args, _ = _bwd_inputs(cuda_device, "causal", 16, torch.float32)
    q, k, v, mask, lse, delta, do = args
    with pytest.raises(ValueError, match="do "):
        tfl.flash_attention_bwd_dq(q, k, v, mask, lse, delta, do.bfloat16(),
                                   causal=True)
    with pytest.raises(ValueError, match="lse must be"):
        tfl.flash_attention_bwd_dkv(q, k, v, mask, lse[:, :2].contiguous(),
                                    delta, do, causal=True)
    # A launch the library refuses (no batch) raises, it never runs.
    dq = torch.empty_like(q)
    strides = [s for t in (q, k, v, do) for s in t.stride()[:3]]
    with pytest.raises(RuntimeError,
                       match="flash_attention_bwd_dq launch failed"):
        kernels.launch("flash_attention_bwd_dq", q.device, q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), None, do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), 0,
                       64, 64, 4, 16, *strides, 1, 0, 0.25, 0)


def _small_llama_grads(dev, dtype="float32"):
    from tpu_engine_torch.models.convert import init_params, params_to
    from tpu_engine_torch.models.registry import create_model
    from tpu_engine_torch.models.transformer import transformer_apply
    from tpu_engine_torch.training.train import (
        cross_entropy_loss,
        tree_leaves,
    )

    cfg = create_model("llama-small-test").config
    params = params_to(init_params(cfg, seed=3, device="cpu", dtype=dtype),
                       dev)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab, (2, 33)).astype(np.int32)).to(dev)
    loss = cross_entropy_loss(transformer_apply(
        params, tok[:, :-1], cfg, dtype=getattr(torch, dtype)), tok[:, 1:])
    loss.backward()
    return params


@pytest.mark.cuda
def test_transformer_apply_grads_on_the_card(cuda_device):
    """Repair: on the card the attention projections get their gradient
    (through the flash backward kernels), equal to the plain path's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    bwd = tfl.flash_attention_bwd_dq
    launches = bwd.launches
    card = _small_llama_grads(cuda_device)
    assert bwd.launches == launches + 2  # one per layer
    cpu = _small_llama_grads(torch.device("cpu"))
    for w in ("wq", "wk", "wv"):
        got = card["blocks"][0]["attn"][w]["kernel"].grad
        ref = cpu["blocks"][0]["attn"][w]["kernel"].grad
        assert float(got.abs().max()) > 0
        assert _rel_err(got.cpu(), ref) < BWD_F32_TOL


@pytest.mark.cuda
def test_bf16_apply_under_autograd_never_detaches(cuda_device):
    """Repair: a bf16 forward on the card under autograd trains every
    parameter, the attention projections included (dense's f32-output bf16
    product has a backward), with the CPU's gradients: per leaf
    max|Δ| / max|ref| within BWD_BF16_TOL, the denominator floored at 1e-3
    of the largest gradient (a value rounded to bf16 on one side may round
    one ulp, 2^-8, away on the other)."""
    from tpu_engine_torch.training.train import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    card = _small_llama_grads(cuda_device, "bfloat16")
    cpu = _small_llama_grads(torch.device("cpu"), "bfloat16")
    wq = card["blocks"][0]["attn"]["wq"]["kernel"].grad
    assert wq is not None and float(wq.float().abs().max()) > 0
    got = [t.grad for t in tree_leaves(card)]
    want = [t.grad for t in tree_leaves(cpu)]
    assert all(g is not None and g.dtype == t.dtype
               for g, t in zip(got, tree_leaves(card)))
    floor = 1e-3 * max(float(w.float().abs().max()) for w in want)
    for g, w in zip(got, want):
        err = float((g.cpu().float() - w.float()).abs().max())
        assert err <= BWD_BF16_TOL * max(float(w.float().abs().max()), floor)


# -- the flash forward at full width ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(1, 1024), (1, 2048), (4, 1024)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_full_width_causal(cuda_device, b, s, dtype, tol):
    """TinyLlama-width causal prompts (32 heads, D 64: many query tiles,
    swept key tiles, fully attended tiles that skip the masks), on out and
    lse, and bit-identical over two runs."""
    rng = np.random.default_rng(s + b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, 32, 64),
                                                    np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    out, lse = _launched(tfl.flash_attention_fwd,
                         lambda: tfl.flash_attention_fwd(q, k, v,
                                                         causal=True))
    ref, ref_lse = tfl.flash_attention_reference(q, k, v, causal=True)
    assert float((out.float() - ref.float()).abs().max()) < tol
    assert float((lse - ref_lse).abs().max()) < tol
    again = tfl.flash_attention_fwd(q, k, v, causal=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal-left-pad", "window-64-pad"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_is_bit_identical_across_runs(cuda_device, case, dtype):
    q, k, v, kw = _flash_inputs(cuda_device, case, 64, dtype)
    first = tfl.flash_attention_fwd(q, k, v, **kw)
    again = tfl.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


# -- the ragged read's split path -----------------------------------------------

# name -> (q_lens, pos0, n_heads, n_kv_heads, d_head, block_size, table_len):
# the main path's mixed tick (seven decode rows at contexts up to 2047 and a
# 256-token chunk at pos0 1700, tables 128 wide: every tile takes up to four
# splits, the chunk's tiles the tensor cores with 64 rows), its decode tick
# (W * G = 8), a narrow tick (W * G = 8 at G 2, qlen 0 rows), D 8 (CUDA
# cores), D 128 and 8-token blocks.
RAGGED_WIDE = {
    "mixed-tick": ((1, 1, 1, 1, 1, 1, 1, 256),
                   (100, 500, 1000, 2046, 17, 1500, 0, 1700), 32, 4, 64,
                   16, 128),
    "decode-tick": ((1,) * 8, (100, 500, 1000, 2046, 17, 1500, 0, 1700), 32,
                    4, 64, 16, 128),
    "narrow-g2": ((4, 1, 3, 0), (600, 20, 700, 5), 4, 2, 32, 16, 48),
    "d8": ((1, 9, 0, 33), (1100, 515, 3, 900), 4, 2, 8, 16, 80),
    "d128": ((64, 1, 17), (700, 1023, 0), 8, 2, 128, 16, 64),
    "bs8-d16": ((1, 40, 2), (1500, 470, 1021), 16, 2, 16, 8, 256),
}


def _wide_inputs(dev, case, dtype, seed=3):
    q_lens, pos0, h, h_kv, d, bs, nb = RAGGED_WIDE[case]
    rng = np.random.default_rng(seed)
    b, w = len(q_lens), max(q_lens)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, w, h, d), np.float32)
    k = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb)
    t = [torch.from_numpy(x).to(dev) for x in (
        q, k, v, tables.astype(np.int32), np.asarray(pos0, np.int32),
        np.asarray(q_lens, np.int32))]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED_WIDE))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ragged_kernel_splits_match_plain(cuda_device, case, dtype, tol):
    t = _wide_inputs(cuda_device, case, dtype)
    out = _launched(tpa.ragged_paged_attention,
                    lambda: tpa.ragged_paged_attention(*t))
    ref = tpa.ragged_paged_attention_reference(*t)
    qlen = t[5].cpu().numpy()
    assert out.dtype == dtype
    assert _valid_err(out, ref, qlen) < tol
    pad = np.arange(out.shape[1])[None, :] >= qlen[:, None]
    assert float(out.float().abs().cpu().numpy()[pad].max(initial=0)) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed-tick", "narrow-g2", "d8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_rows_are_bit_identical_alone_and_across_runs(cuda_device,
                                                             case, dtype):
    """Two runs give the same bits, and each row's output is bit-identical
    run alone (a batch of one, W its own qlen) and beside the other rows:
    its split count and its arithmetic depend on its own data only."""
    t = _wide_inputs(cuda_device, case, dtype)
    out = tpa.ragged_paged_attention(*t)
    assert torch.equal(out, tpa.ragged_paged_attention(*t))
    for r, ql in enumerate(t[5].tolist()):
        w = max(ql, 1)
        alone = tpa.ragged_paged_attention(
            t[0][r:r + 1, :w].contiguous(), t[1], t[2], t[3][r:r + 1],
            t[4][r:r + 1], t[5][r:r + 1])
        assert torch.equal(alone[0, :ql], out[r, :ql])


# -- the decode read's split path ------------------------------------------------

# name -> (pos, n_heads, n_kv_heads, d_head, block_size, table_len): the
# main path's decode step (8 rows at contexts up to 2047, up to 32 splits
# of 64 keys), D 8 and D 128 past one split, G = 1 over 8-token blocks,
# splits that end mid-block (48-token blocks), and G * D = 4096 (the split
# kernel holds no accumulator per thread across tiles, over any pool).
PAGED_WIDE = {
    "smoke-decode": ((100, 500, 1000, 2046, 17, 1500, 0, 1700), 32, 4, 64,
                     16, 128),
    "d8-long": ((2047, 5, 1000, 0), 4, 2, 8, 16, 128),
    "d128": ((700, 1023, 0, 129), 8, 2, 128, 16, 64),
    "g1-bs8": ((300, 1, 127, 128), 2, 2, 16, 8, 64),
    "bs48-mid-block": ((400, 1000, 47), 4, 2, 32, 48, 24),
    "g32-d128": ((900, 3), 64, 2, 128, 16, 64),
}
PAGED_SPLIT_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


def _paged_wide(dev, case, dtype, seed=5):
    pos, h, h_kv, d, bs, nb = PAGED_WIDE[case]
    rng = np.random.default_rng(seed)
    b = len(pos)
    n_pool = b * nb + 1
    q = rng.standard_normal((b, 1, h, d), np.float32)
    k = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    v = rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb)
    t = [torch.from_numpy(x).to(dev) for x in (
        q, k, v, tables.astype(np.int32), np.asarray(pos, np.int32))]
    t[1], t[2] = t[1].to(dtype), t[2].to(dtype)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_WIDE))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_paged_kernel_splits_match_plain(cuda_device, case, dtype, tol):
    """The split decode kernel against its split plain version (tight)
    and the dense plain version (the read's tolerance)."""
    t = _paged_wide(cuda_device, case, dtype)
    out = _launched(tpa.paged_attention, lambda: tpa.paged_attention(*t))
    split = tpa.paged_attention_split_reference(*t)
    dense = tpa.paged_attention_reference(*t)
    assert out.dtype == dtype
    assert float((out.float() - split.float()).abs().max()) \
        < PAGED_SPLIT_TOL[dtype]
    assert float((out.float() - dense.float()).abs().max()) < tol
    plan = tpa.decode_split_plan(t[4].cpu().numpy(), t[1].shape[1],
                                 t[3].shape[1])
    assert plan.max() > 1  # the merge pass runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smoke-decode", "d8-long", "g1-bs8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_rows_are_bit_identical_alone_and_across_runs(cuda_device,
                                                            case, dtype):
    """Two runs give the same bits, and each row's output is bit-identical
    run alone and beside the other rows."""
    t = _paged_wide(cuda_device, case, dtype)
    out = tpa.paged_attention(*t)
    assert torch.equal(out, tpa.paged_attention(*t))
    for r in range(t[0].shape[0]):
        alone = tpa.paged_attention(t[0][r:r + 1].contiguous(), t[1], t[2],
                                    t[3][r:r + 1], t[4][r:r + 1])
        assert torch.equal(alone[0], out[r])


@pytest.mark.cuda
def test_paged_kernel_refuses_what_shared_memory_cannot_hold(cuda_device):
    """The cap that remains: a split's K and V rows, q and scores within a
    thread block's shared memory (G 256 at D 128 over an f32 pool)."""
    t = _on(cuda_device, tpa.parity_inputs(n_heads=256, n_kv_heads=1,
                                           d_head=128))
    assert tpa.decode_smem_bytes(256, 128, 4) > tpa.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        tpa.paged_attention(*t)


# -- the int8 ragged read's split path ----------------------------------------------

def _quant_wide(dev, case, seed=3):
    """RAGGED_WIDE's inputs over the int8 pool the port's quantize_kv makes
    of the same f32 values."""
    from tpu_engine_torch.ops.quant import quantize_kv

    q, k, v, tables, pos0, qlen = _wide_inputs(dev, case, torch.float32,
                                               seed)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return [q, kq, vq, ks, vs, tables, pos0, qlen]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED_WIDE))
def test_quant_ragged_kernel_splits_match_plain(cuda_device, case):
    t = _quant_wide(cuda_device, case)
    out = _launched(tpa.quant_ragged_paged_attention,
                    lambda: tpa.quant_ragged_paged_attention(*t))
    split = tpa.quant_ragged_paged_attention_split_reference(*t)
    dense = tpa.quant_ragged_paged_attention_reference(*t)
    qlen = t[7].cpu().numpy()
    assert out.dtype == torch.float32
    assert _valid_err(out, split, qlen) < QUANT_TOL
    assert _valid_err(out, dense, qlen) < QUANT_TOL
    pad = np.arange(out.shape[1])[None, :] >= qlen[:, None]
    assert float(out.abs().cpu().numpy()[pad].max(initial=0)) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed-tick", "decode-tick", "narrow-g2",
                                  "d8"])
def test_quant_ragged_rows_are_bit_identical_alone_and_across_runs(
        cuda_device, case):
    t = _quant_wide(cuda_device, case)
    out = tpa.quant_ragged_paged_attention(*t)
    assert torch.equal(out, tpa.quant_ragged_paged_attention(*t))
    for r, ql in enumerate(t[7].tolist()):
        w = max(ql, 1)
        alone = tpa.quant_ragged_paged_attention(
            t[0][r:r + 1, :w].contiguous(), *t[1:5], t[5][r:r + 1],
            t[6][r:r + 1], t[7][r:r + 1])
        assert torch.equal(alone[0, :ql], out[r, :ql])


# -- the int8 decode read's split path ----------------------------------------------

def _quant_paged_wide(dev, case, seed=5):
    """PAGED_WIDE's inputs over the int8 pool the port's quantize_kv makes
    of the same f32 values: (q, k_pool, v_pool, k_scale, v_scale, tables,
    pos)."""
    from tpu_engine_torch.ops.quant import quantize_kv

    q, k, v, tables, pos = _paged_wide(dev, case, torch.float32, seed)
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return [q, kq, vq, ks, vs, tables, pos]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_WIDE))
def test_quant_paged_kernel_splits_match_plain(cuda_device, case):
    """The int8 decode read on the split kernel against its split plain
    version and the dense plain version, G 32 x D 128 and D 8 included."""
    t = _quant_paged_wide(cuda_device, case)
    out = _launched(tpa.quant_paged_attention,
                    lambda: tpa.quant_paged_attention(*t))
    split = tpa.quant_paged_attention_split_reference(*t)
    dense = tpa.quant_paged_attention_reference(*t)
    assert out.dtype == torch.float32
    assert float((out - split).abs().max()) < QUANT_SPLIT_TOL
    assert float((out - dense).abs().max()) < QUANT_TOL
    plan = tpa.decode_split_plan(t[6].cpu().numpy(), t[1].shape[1],
                                 t[5].shape[1])
    assert plan.max() > 1  # the merge pass runs


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["smoke-decode", "d8-long", "g1-bs8",
                                  "g32-d128"])
def test_quant_paged_rows_are_bit_identical_alone_and_across_runs(
        cuda_device, case):
    t = _quant_paged_wide(cuda_device, case)
    out = tpa.quant_paged_attention(*t)
    assert torch.equal(out, tpa.quant_paged_attention(*t))
    for r in range(t[0].shape[0]):
        alone = tpa.quant_paged_attention(t[0][r:r + 1].contiguous(),
                                          *t[1:5], t[5][r:r + 1],
                                          t[6][r:r + 1])
        assert torch.equal(alone[0], out[r])


@pytest.mark.cuda
def test_quant_paged_kernel_refuses_what_shared_memory_cannot_hold(
        cuda_device):
    """The int8 read's one cap, as the bf16/f32 read's: a split's rows,
    scales, q and scores within a thread block's shared memory (G 512 at
    D 128: q alone takes 256 KB), refused by name before any launch."""
    t = _on(cuda_device, tpa.parity_inputs(n_heads=512, n_kv_heads=1,
                                           d_head=128, quant=True))
    assert tpa.decode_smem_bytes(512, 128, 1) > tpa.MAX_SMEM_BYTES
    launches = tpa.quant_paged_attention.launches
    with pytest.raises(ValueError, match="shared memory"):
        tpa.quant_paged_attention(*t)
    assert tpa.quant_paged_attention.launches == launches


# -- the reads on the speculative lanes' path ---------------------------------

def _verify_inputs(dev, k, g, dtype=torch.float32, quant=False, seed=7):
    """One ragged batch of a --spec-k tick at D 64 over 16-token blocks:
    an undrafted decode row, two k+1 verify windows (one across the
    512-key split, one across a block edge) and prefill chunks of 16 and
    17 tokens, G = g query heads per KV head (two KV heads)."""
    from tpu_engine_torch.ops.quant import quantize_kv

    q_lens = (1, k + 1, k + 1, 16, 17)
    pos0 = (100, 512 - k // 2 - 1, 30, 300, 600)
    rng = np.random.default_rng(seed)
    b, w, h_kv, d, bs, nb = len(q_lens), max(q_lens), 2, 64, 16, 48
    n_pool = b * nb + 1
    q = rng.standard_normal((b, w, g * h_kv, d), np.float32)
    kv = [rng.standard_normal((n_pool, bs, h_kv, d), np.float32)
          for _ in range(2)]
    tables = (1 + rng.permutation(n_pool - 1)).reshape(b, nb)
    meta = [torch.from_numpy(x).to(dev) for x in (
        tables.astype(np.int32), np.asarray(pos0, np.int32),
        np.asarray(q_lens, np.int32))]
    kv = [torch.from_numpy(x).to(dev) for x in kv]
    if quant:
        (kq, ks), (vq, vs) = quantize_kv(kv[0]), quantize_kv(kv[1])
        return [torch.from_numpy(q).to(dev), kq, vq, ks, vs, *meta]
    return [torch.from_numpy(q).to(dev), kv[0].to(dtype), kv[1].to(dtype),
            *meta]


def _rows_alone(fn, t, out):
    qlen = t[-1]
    for r, ql in enumerate(qlen.tolist()):
        alone = fn(t[0][r:r + 1, :max(ql, 1)].contiguous(), *t[1:-3],
                   t[-3][r:r + 1], t[-2][r:r + 1], t[-1][r:r + 1])
        assert torch.equal(alone[0, :ql], out[r, :ql])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 7])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ragged_kernel_at_the_verify_shape(cuda_device, k, g, dtype, tol):
    t = _verify_inputs(cuda_device, k, g, dtype)
    out = _launched(tpa.ragged_paged_attention,
                    lambda: tpa.ragged_paged_attention(*t))
    qlen = t[-1].cpu().numpy()
    for ref in (tpa.ragged_paged_attention_reference(*t),
                tpa.ragged_paged_attention_split_reference(*t)):
        assert _valid_err(out, ref, qlen) < tol
    assert torch.equal(out, tpa.ragged_paged_attention(*t))
    _rows_alone(tpa.ragged_paged_attention, t, out)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 4, 7])
@pytest.mark.parametrize("g", [1, 8])
def test_quant_ragged_kernel_at_the_verify_shape(cuda_device, k, g):
    t = _verify_inputs(cuda_device, k, g, quant=True)
    out = _launched(tpa.quant_ragged_paged_attention,
                    lambda: tpa.quant_ragged_paged_attention(*t))
    qlen = t[-1].cpu().numpy()
    for ref in (tpa.quant_ragged_paged_attention_reference(*t),
                tpa.quant_ragged_paged_attention_split_reference(*t)):
        assert _valid_err(out, ref, qlen) < QUANT_TOL
    assert torch.equal(out, tpa.quant_ragged_paged_attention(*t))
    _rows_alone(tpa.quant_ragged_paged_attention, t, out)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_the_draft_prefill(cuda_device, dtype, tol):
    """The draft model's prefill: B 1 x S 64 of gpt2 width (12 heads,
    D 64), causal, its first 20 columns left padding."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 12, 64),
                                                    np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    m = np.ones((1, 64), np.int32)
    m[:, :20] = 0
    kw = dict(causal=True, mask=torch.from_numpy(m).to(cuda_device))
    out, lse = _launched(tfl.flash_attention_fwd,
                         lambda: tfl.flash_attention_fwd(q, k, v, **kw))
    ref, ref_lse = tfl.flash_attention_reference(q, k, v, **kw)
    assert float((out.float() - ref.float()).abs().max()) < tol
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead)
    assert float(torch.where(dead, 0.0, lse - ref_lse).abs().max()) < tol
    again = tfl.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


# -- the bert lane (encoder: non-causal, padding mask) ------------------------

def bert_masks(b: int, s: int, seed: int) -> np.ndarray:
    """(b, s) int32 padding masks of the bert lane: valid prefixes of
    varied lengths (1, short ones, s), the last row all pad."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s + 1, b)
    lens[:4] = [1, 17, 63, s][:min(4, b)]
    lens[-1] = 0
    return (np.arange(s)[None, :] < lens[:, None]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernel_at_the_bert_shape(cuda_device, b, dtype, tol):
    """The bert lane's attention: B x 384 x 12 heads x D 64, non-causal,
    right padding masked, an all-pad row (out 0, lse -inf, no NaN), on
    out and lse, and bit-identical over two runs."""
    s = 384
    rng = np.random.default_rng(b)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, 12, 64),
                                                    np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    m = torch.from_numpy(bert_masks(b, s, b + 1)).to(cuda_device)
    kw = dict(causal=False, mask=m)
    out, lse = _launched(tfl.flash_attention_fwd,
                         lambda: tfl.flash_attention_fwd(q, k, v, **kw))
    ref, ref_lse = tfl.flash_attention_reference(q, k, v, **kw)
    assert torch.isfinite(out).all()
    assert float((out.float() - ref.float()).abs().max()) < tol
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    dead = torch.isinf(ref_lse)
    assert torch.equal(torch.isinf(lse), dead) and bool(dead[-1].all())
    assert float(torch.where(dead, 0.0, lse - ref_lse).abs().max()) < tol
    again = tfl.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
def test_bert_small_lane_on_the_card_matches_the_cpu(cuda_device):
    """bert-small-test's forward in f32 (TF32 off) on the card, through
    the flash kernel, against the same weights on the CPU, with an all-pad
    row."""
    from tpu_engine_torch.models.convert import params_to
    from tpu_engine_torch.models.registry import create_model

    spec = create_model("bert-small-test")
    params = spec.init(0, device="cpu", dtype="float32")
    x = torch.from_numpy(np.random.default_rng(4).integers(
        1, 512, (4, 32)).astype(np.float32))
    x[1, 9:] = 0
    x[3] = 0
    want = spec.apply(params, x, dtype=torch.float32)
    before = tfl.flash_attention_fwd.launches
    got = spec.apply(params_to(params, cuda_device), x.to(cuda_device),
                     dtype=torch.float32)
    torch.cuda.synchronize()
    assert tfl.flash_attention_fwd.launches == before + 2  # two layers
    assert torch.isfinite(got).all()
    assert float((got.cpu() - want).abs().max()) < 1e-4
