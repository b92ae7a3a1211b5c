"""Transformer forwards of the serving and training paths (counterpart of
``tpu_engine/models/transformer.py``): the full-sequence forward
(``transformer_apply``, differentiable, optionally rematerialized per
block), of the decoder dialects and of the encoder dialect (BERT: post-LN
blocks, LayerNorm'd embeddings with a segment table, erf GELU, a padding
mask, no causal mask; one-shot forwards only); the dense scheduler's prompt pass
(``transformer_prefill``, through the flash kernel) and its per-row decode
step over the dense cache (``transformer_decode_rows``; the batch
Generator's one-column-for-all form, ``transformer_decode_step``); prefill
windows over a row's own dense cache and the batch speculative loop's
draft and verify windows (``transformer_decode_window``); and the paged
paths, the ragged mixed step and the two-path decode step over the block
pool, each over a bf16/f32 or an int8 pool.

Parameters are a dict tree with the JAX package's names, except that the
stacked (L, ...) ``blocks`` tree becomes a list of per-layer dicts: the
``lax.scan`` over layers is a Python loop here. Matmul kernels may be
stored in the compute dtype (``models.convert`` does so); ``nn.dense``
casts them at use, so a stored cast and an apply-time cast round alike.
Embedding tables, biases and norm scales stay f32, as in JAX.

A config with experts (``n_experts > 0``, the gpt2-moe family) runs the
mixture-of-experts FFN (``ops.moe``) in every forward. Its capacity
slots are shared by every token of a call, padding and free slots
included, so each forward hands it the same (B, T) tensor as its JAX
twin. ``expert_parallel_params`` splits each block's expert bank over a
mesh's ``expert`` axis, and the forwards then run the banks
expert-parallel (``ops.moe``).

The rounding points follow the JAX forward: the residual adds promote to
f32 (``nn.dense`` returns f32) and the carry is cast back to the compute
dtype only at each block's end.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.utils.checkpoint

from tpu_engine_torch.ops import nn
from tpu_engine_torch.ops.attention import (
    _split_heads,
    dot_product_attention,
    repeat_kv,
    rope,
)
from tpu_engine_torch.ops.flash import flash_attention
from tpu_engine_torch.ops.moe import MoEConfig, moe_apply, shard_moe_params
from tpu_engine_torch.ops.quant import quantize_kv
from tpu_engine_torch.parallel.mesh import place
from tpu_engine_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The port's copy of ``tpu_engine.models.transformer.TransformerConfig``
    (same fields and defaults; that module imports jax)."""
    vocab: int = 50257
    n_layers: int = 12
    d_model: int = 768
    n_heads: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    causal: bool = True
    post_ln: bool = False
    embed_ln: bool = False
    type_vocab: int = 0
    gelu_tanh: bool = True
    ln_eps: float = 1e-5
    norm: str = "layernorm"     # "layernorm" | "rmsnorm"
    pos: str = "learned"        # "learned" | "rope"
    mlp_act: str = "gelu"       # "gelu" | "swiglu"
    n_kv_heads: Optional[int] = None
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def moe(self) -> MoEConfig:
        return MoEConfig(d_model=self.d_model, d_ff=self.d_ff,
                         n_experts=self.n_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor)


class KVCache(NamedTuple):
    """A K/V pair: pool tensors (L, NB, bs, H_kv, D), their int8 pool's
    scales (L, NB, bs, H_kv), or a dense row cache (L, B, S, H_kv, D)."""
    k: torch.Tensor
    v: torch.Tensor


class TPParams(NamedTuple):
    """A decoder sharded over a tensor-parallel group
    (``parallel.mesh.TPGroup``): ``ranks[r]`` is rank r's parameter tree
    on ``group.devices[r]`` (``models.registry.tp_rank_trees``). The
    serving forwards take it in place of a parameter tree, with caches
    sharded on H_kv: a ``KVCache`` whose fields hold one tensor per
    rank."""
    ranks: list
    group: object


def init_caches(cfg: TransformerConfig, batch: int,
                max_seq: Optional[int] = None, dtype=torch.bfloat16,
                device=None) -> KVCache:
    """Zeroed dense cache (L, batch, max_seq, H_kv, D): the dense
    scheduler's shared cache, and a request's own row cache during its
    prefill (dense scheduler) or prefill windows (two-path scheduler).
    ``device`` None is the CUDA card."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq or cfg.max_seq, cfg.kv_heads,
             cfg.d_head)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _norm(params, x, cfg: TransformerConfig):
    return (nn.rmsnorm(params, x, eps=cfg.ln_eps) if cfg.norm == "rmsnorm"
            else nn.layernorm(params, x, eps=cfg.ln_eps))


def _mlp(params, h, dtype, cfg: TransformerConfig):
    """The block's FFN; a mixture of experts (``ops.moe``) over every
    token of ``h`` (B, T, d), padding included, when the config has
    experts."""
    if cfg.n_experts > 0:
        return moe_apply(params, h, cfg.moe, dtype=dtype)
    if cfg.mlp_act == "swiglu":
        gate = nn.silu(nn.dense(params["gate"], h, dtype=dtype))
        return nn.dense(params["proj"],
                        gate * nn.dense(params["up"], h, dtype=dtype),
                        dtype=dtype)
    h = nn.dense(params["fc"], h, dtype=dtype)
    h = nn.gelu(h, approximate=cfg.gelu_tanh)
    return nn.dense(params["proj"], h, dtype=dtype)


def _project_qkv(bp, x, cfg: TransformerConfig, *, dtype, positions,
                 tp: int = 1):
    """Q, K, V (B, T, heads, D) of the block, rope applied. ``tp`` > 1:
    a tensor-parallel rank's projection onto its H/tp query and H_kv/tp
    KV heads."""
    q = _split_heads(nn.dense(bp["attn"]["wq"], x, dtype=dtype),
                     cfg.n_heads // tp)
    k = _split_heads(nn.dense(bp["attn"]["wk"], x, dtype=dtype),
                     cfg.kv_heads // tp)
    v = _split_heads(nn.dense(bp["attn"]["wv"], x, dtype=dtype),
                     cfg.kv_heads // tp)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _embed(params, tokens, logical, cfg: TransformerConfig, dtype):
    """Token embeddings plus, for learned positions, the table rows of the
    (clipped) logical positions; for the encoder dialect also the segment
    table's row 0 (every token type is 0) and the embedding LayerNorm, in
    f32; cast to the compute dtype."""
    h = nn.embedding(params["tok_embed"], tokens.long())
    if cfg.pos == "learned":
        table = params["pos_embed"]["table"]
        h = h + table[torch.clamp(logical.long(), 0, table.shape[0] - 1)]
    if cfg.type_vocab > 0:
        h = h + params["type_embed"]["table"][0]
    if cfg.embed_ln:
        h = nn.layernorm(params["embed_ln"], h, eps=cfg.ln_eps)
    return h.to(dtype)


def _head(params, h, cfg: TransformerConfig, dtype):
    """The output projection: after the final norm, except in post-LN
    dialects, whose blocks end normalized and which have no ``ln_f``."""
    if not cfg.post_ln:
        h = _norm(params["ln_f"], h, cfg)
    return nn.dense(params["head"], h, dtype=dtype).float()


def _is_encoder(cfg: TransformerConfig) -> bool:
    return bool(cfg.post_ln or cfg.embed_ln or cfg.type_vocab
                or not cfg.causal)


def _check_dialect(cfg: TransformerConfig, encoder: bool = False) -> None:
    """Refuse the encoder dialect everywhere but the full-sequence forward
    (``encoder=True``), since an encoder has no generation lane."""
    if not encoder and _is_encoder(cfg):
        raise NotImplementedError(
            "the encoder dialect (post_ln, embed_ln, type_vocab, "
            "non-causal) serves only the full-sequence forward "
            "(transformer_apply): an encoder has no generation lane")


def _check_paged(cfg: TransformerConfig) -> None:
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            "sliding_window models are not supported by the paged KV "
            "cache (use the dense scheduler)")
    _check_dialect(cfg)


def _write_kv(ck, cv, scales, blk, off, k, v) -> None:
    """Write new tokens' K/V into pool slots (blk, off), in place. With the
    int8 pool's layer scales (ks, vs), each (slot, kv-head) vector
    quantizes here, exactly once, and its scale is written beside it."""
    if scales is None:
        ck.index_put_((blk, off), k.to(ck.dtype))
        cv.index_put_((blk, off), v.to(cv.dtype))
        return
    ks, vs = scales
    qk, sk = quantize_kv(k)
    qv, sv = quantize_kv(v)
    ck.index_put_((blk, off), qk)
    cv.index_put_((blk, off), qv)
    ks.index_put_((blk, off), sk)
    vs.index_put_((blk, off), sv)


def _block_step_rows_ragged(bp, h, ck, cv, tables, pos0, qlen,
                            cfg: TransformerConfig, *, dtype, attn_fn,
                            scales=None):
    """One layer of the ragged mixed step. ck/cv are this layer's
    (NB, bs, H_kv, D) pool slices, updated IN PLACE: all W slots' K/V are
    written into the rows' blocks before the attention read
    (write-before-attend); padding slots (i >= qlen) write into the null
    block 0, and columns past the table are clipped to its last column.
    ``scales``: the int8 pool's layer scales (ks, vs); the chunk's tokens
    quantize at their write, before their own read."""
    bs = ck.shape[1]
    b, w = h.shape[:2]
    x = _norm(bp["ln1"], h, cfg)
    offs = torch.arange(w, device=h.device)[None, :]
    logical = pos0[:, None].long() + offs                      # (B, W)
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=logical)
    rows = torch.arange(b, device=h.device)[:, None]
    max_col = tables.shape[1] * bs - 1
    cols = torch.clamp(logical, max=max_col)
    blk = tables.long()[rows, cols // bs]
    blk = torch.where(offs < qlen[:, None].long(), blk, 0)
    off = cols % bs
    _write_kv(ck, cv, scales, blk, off, k, v)
    if scales is None:
        a = attn_fn(q, ck, cv, tables, pos0, qlen)
    else:
        a = attn_fn(q, ck, cv, scales[0], scales[1], tables, pos0, qlen)
    a = a.to(dtype)
    h = h + nn.dense(bp["attn"]["wo"], a.reshape(b, w, -1), dtype=dtype)
    h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def transformer_step_rows_ragged(params, tokens, caches: KVCache, tables,
                                 pos0, qlen, cfg: TransformerConfig, *,
                                 dtype=torch.bfloat16, attn_fn=None,
                                 sample_slot=None, sample_width: int = 1,
                                 scales=None):
    """The mixed prefill+decode primitive: one ragged batch where row b
    consumes qlen[b] >= 0 new tokens at logical columns
    [pos0[b], pos0[b] + qlen[b]), writing their K/V into the row's pool
    blocks in the same call.

    tokens: (B, W) int, right-aligned at slot 0; caches: KVCache of
    (L, NB, bs, H_kv, D) pools (updated in place and returned); tables:
    (B, nb) int32 block tables; pos0, qlen: (B,) int32. ``attn_fn``
    defaults to ``ops.paged_attention.ragged_paged_attention`` (the CUDA
    kernel on CUDA tensors), or with ``scales`` (the int8 pool's KVCache
    of (L, NB, bs, H_kv) f32, updated in place) to
    ``quant_ragged_paged_attention``; the return then grows to
    (logits, caches, scales).

    ``sample_slot`` (B,) selects one slot per row to project through the
    LM head; the hidden state is gathered BEFORE ln_f and the head, so the
    head multiplies (B, d) and not (B*W, d). ``sample_width`` > 1 widens
    the gather to slots sample_slot..sample_slot + width - 1 (clipped to
    W-1). Returns (logits (B, vocab), caches), or (B, sample_width, vocab)
    when sample_width > 1, or (B, W, vocab) without ``sample_slot``.

    A ``TPParams`` model runs the tensor-parallel form over the sharded
    pool (``caches`` and ``scales`` with one tensor per rank)."""
    _check_paged(cfg)
    if attn_fn is None:
        from tpu_engine_torch.ops import paged_attention as pa

        attn_fn = (pa.ragged_paged_attention if scales is None
                   else pa.quant_ragged_paged_attention)
    if isinstance(params, TPParams):
        return _tp_step_rows_ragged(
            params, tokens, caches, tables, pos0, qlen, cfg, dtype=dtype,
            attn_fn=attn_fn, sample_slot=sample_slot,
            sample_width=sample_width, scales=scales)
    b, w = tokens.shape
    logical = pos0[:, None].long() + torch.arange(w, device=tokens.device)
    h = _embed(params, tokens, logical, cfg, dtype)
    for li, bp in enumerate(params["blocks"]):
        h = _block_step_rows_ragged(
            bp, h, caches.k[li], caches.v[li], tables, pos0, qlen, cfg,
            dtype=dtype, attn_fn=attn_fn,
            scales=None if scales is None else (scales.k[li], scales.v[li]))
    h = _sample_slots(h, sample_slot, sample_width)
    logits = _head(params, h, cfg, dtype)
    if sample_slot is not None and sample_width == 1:
        logits = logits[:, 0]
    if scales is not None:
        return logits, caches, scales
    return logits, caches


def _sample_slots(h, sample_slot, sample_width: int):
    """The hidden states (B, S, d) of slots sample_slot..sample_slot +
    width - 1 of each row (clipped to W - 1), or all of ``h`` when
    ``sample_slot`` is None."""
    if sample_slot is None:
        return h
    b, w = h.shape[:2]
    slots = torch.clamp(
        sample_slot[:, None].long()
        + torch.arange(sample_width, device=h.device)[None, :],
        max=w - 1)
    return h[torch.arange(b, device=h.device)[:, None], slots]


def _block_decode_rows_paged(bp, h, ck, cv, tables, pos_vec,
                             cfg: TransformerConfig, *, dtype, attn_fn,
                             scales=None):
    """One decode step of one layer against the block pool: ck/cv are the
    layer's (NB, bs, H_kv, D) pool slices. Paged rows are 0-aligned, so
    pos_vec IS the logical position. The new token's K/V is written into
    its block (in place) before the attention read; with the int8 pool's
    layer scales it quantizes there, once."""
    bs = ck.shape[1]
    b = h.shape[0]
    x = _norm(bp["ln1"], h, cfg)
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype,
                           positions=pos_vec[:, None].long())
    rows = torch.arange(b, device=h.device)
    pos = pos_vec.long()
    blk = tables.long()[rows, pos // bs]
    _write_kv(ck, cv, scales, blk, pos % bs, k[:, 0], v[:, 0])
    if scales is None:
        a = attn_fn(q, ck, cv, tables, pos_vec)
    else:
        a = attn_fn(q, ck, cv, scales[0], scales[1], tables, pos_vec)
    a = a.to(dtype)
    h = h + nn.dense(bp["attn"]["wo"], a.reshape(b, 1, -1), dtype=dtype)
    h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def transformer_decode_rows_paged(params, token_t, caches: KVCache, tables,
                                  pos_vec, cfg: TransformerConfig, *,
                                  dtype=torch.bfloat16, attn_fn=None,
                                  scales: Optional[KVCache] = None):
    """One decode step of every row over the block pool (the two-path
    scheduler's decode chunk runs ``step_chunk`` of them). token_t: (B,)
    the rows' last tokens; caches: (L, NB, bs, H_kv, D) pool pair,
    updated in place; tables: (B, nb) int32 block tables (0 = the null
    block, masked by pos); pos_vec: (B,) int32 logical write positions.
    ``attn_fn`` defaults to ``ops.paged_attention.paged_attention`` (the
    CUDA kernel on CUDA tensors), or with ``scales`` (the int8 pool's
    scales, updated in place) to ``quant_paged_attention``. Returns
    (logits (B, vocab), caches), or (logits, caches, scales). A
    ``TPParams`` model runs the tensor-parallel form over the sharded
    pool."""
    _check_paged(cfg)
    if attn_fn is None:
        from tpu_engine_torch.ops import paged_attention as pa

        attn_fn = (pa.paged_attention if scales is None
                   else pa.quant_paged_attention)
    if isinstance(params, TPParams):
        return _tp_decode_rows_paged(params, token_t, caches, tables,
                                     pos_vec, cfg, dtype=dtype,
                                     attn_fn=attn_fn, scales=scales)
    h = _embed(params, token_t[:, None], pos_vec[:, None], cfg, dtype)
    for li, bp in enumerate(params["blocks"]):
        h = _block_decode_rows_paged(
            bp, h, caches.k[li], caches.v[li], tables, pos_vec, cfg,
            dtype=dtype, attn_fn=attn_fn,
            scales=None if scales is None else (scales.k[li], scales.v[li]))
    logits = _head(params, h, cfg, dtype)[:, 0]
    if scales is not None:
        return logits, caches, scales
    return logits, caches


def _block_decode_window(bp, h, ck, cv, pos_vec, start_vec,
                         cfg: TransformerConfig, *, dtype, drop_past):
    """One layer of a W-token window per row against a dense row cache:
    ck/cv (B, S, H_kv, D), updated in place. Row b writes columns
    [pos_vec[b], pos_vec[b] + W) before the attention read (with
    ``drop_past`` a column past the cache is dropped), and window slot i
    attends columns start_vec[b] <= kpos <= pos_vec[b] + i (inside the
    sliding band, for models that have one)."""
    b, w = h.shape[:2]
    x = _norm(bp["ln1"], h, cfg)
    offs = torch.arange(w, device=h.device)[None, :]
    logical = (pos_vec - start_vec).long()[:, None] + offs
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=logical)
    a = _window_write_attend(q, k, v, ck, cv, pos_vec, start_vec, cfg,
                             drop_past=drop_past)
    h = h + nn.dense(bp["attn"]["wo"], a.reshape(b, w, -1), dtype=dtype)
    h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def _window_write_attend(q, k, v, ck, cv, pos_vec, start_vec,
                         cfg: TransformerConfig, *, drop_past):
    """A window's K/V written into the row cache ck/cv (B, S, H_kv, D) at
    columns [pos_vec, pos_vec + W), then its queries' attention over the
    cache (see ``_block_decode_window``)."""
    b, w = q.shape[:2]
    offs = torch.arange(w, device=q.device)[None, :]
    rows = torch.arange(b, device=q.device)[:, None]
    cols = pos_vec.long()[:, None] + offs                    # (B, W)
    if drop_past:
        # A column past the cache is dropped, as JAX's scatter drops it:
        # its write lands on column - W instead (below the row's window,
        # so no two writes of a row meet there) with the value already
        # there.
        inside = (cols < ck.shape[1])[..., None, None]
        at = torch.where(cols < ck.shape[1], cols, cols - w)
        ck[rows, at] = torch.where(inside, k.to(ck.dtype), ck[rows, at])
        cv[rows, at] = torch.where(inside, v.to(cv.dtype), cv[rows, at])
    else:
        ck[rows, cols] = k.to(ck.dtype)
        cv[rows, cols] = v.to(cv.dtype)
    kpos = torch.arange(ck.shape[1], device=q.device)[None, None, :]
    valid = ((kpos <= cols[:, :, None])
             & (kpos >= start_vec.long()[:, None, None]))
    if cfg.sliding_window is not None:
        valid = valid & (kpos > cols[:, :, None] - cfg.sliding_window)
    return dot_product_attention(q, ck, cv, mask=valid.to(torch.int32))


def transformer_decode_window(params, tokens, caches: KVCache, pos_vec,
                              cfg: TransformerConfig, *,
                              dtype=torch.bfloat16, start_vec=None,
                              head: str = "all", drop_past: bool = False):
    """Consume a W-token window per row against a dense row cache in one
    pass (the two-path scheduler's prefill windows). tokens: (B, W), row
    b's tokens at cache columns [pos_vec[b], pos_vec[b] + W); caches:
    (L, B, S, H_kv, D), updated in place; start_vec: (B,) first valid
    column per row (default 0). ``head``: "all" projects every slot
    through the LM head ((B, W, vocab)), "last" only the final slot
    ((B, 1, vocab)), "none" none (logits None). Returns (logits, caches),
    where logits[:, i] predicts the token after tokens[:, i]. Callers keep
    pos_vec + W <= S, or pass ``drop_past`` to drop the writes past the
    cache (the batch speculative loop's finished rows make such writes;
    their outputs are discarded). A ``TPParams`` model runs the
    tensor-parallel form over per-rank row caches (``tp_init_caches``)."""
    _check_dialect(cfg)
    if start_vec is None:
        start_vec = torch.zeros_like(pos_vec)
    if isinstance(params, TPParams):
        return _tp_decode_window(params, tokens, caches, pos_vec, cfg,
                                 dtype=dtype, start_vec=start_vec,
                                 head=head, drop_past=drop_past)
    w = tokens.shape[1]
    logical = ((pos_vec - start_vec).long()[:, None]
               + torch.arange(w, device=tokens.device)[None, :])
    h = _embed(params, tokens, logical, cfg, dtype)
    for li, bp in enumerate(params["blocks"]):
        h = _block_decode_window(bp, h, caches.k[li], caches.v[li],
                                 pos_vec, start_vec, cfg, dtype=dtype,
                                 drop_past=drop_past)
    if head == "none":
        return None, caches
    if head == "last":
        h = h[:, -1:]
    return _head(params, h, cfg, dtype), caches


# -- full-sequence forward and the dense scheduler's paths ---------------------


def _band(cfg: TransformerConfig) -> dict:
    """The sliding band, passed only when the config has one, so an
    ``attn_fn`` that cannot band-mask fails loudly rather than attending
    full-causal."""
    if cfg.sliding_window is None:
        return {}
    return {"window": cfg.sliding_window}


def _attn(bp, x, cfg: TransformerConfig, *, mask, dtype, attn_fn,
          positions):
    """Full-sequence attention sublayer: grouped K/V expanded to the query
    heads (the flash kernel takes equal head counts), causal per the
    config, the padding mask, the band."""
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=positions)
    n_rep = cfg.n_heads // cfg.kv_heads
    a = attn_fn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                causal=cfg.causal, mask=mask, **_band(cfg))
    b, s = a.shape[:2]
    return nn.dense(bp["attn"]["wo"], a.reshape(b, s, -1), dtype=dtype)


def _block_apply(bp, h, cfg: TransformerConfig, *, mask, dtype,
                 attn_fn=None, positions=None):
    """One block of the full-sequence forward (JAX's ``_block_apply``):
    pre-norm sublayers with residual adds (post-LN in the encoder
    dialect), the carry cast back to the compute dtype at the end.
    ``attn_fn`` defaults to ``ops.flash.flash_attention``; ``positions``
    (the rope phases) to ``arange`` over the sequence."""
    attn_fn = attn_fn or flash_attention
    if positions is None:
        positions = torch.arange(h.shape[1], device=h.device)
    if cfg.post_ln:  # sublayer, residual add, then LayerNorm
        h = _norm(bp["ln1"], h + _attn(bp, h, cfg, mask=mask, dtype=dtype,
                                       attn_fn=attn_fn,
                                       positions=positions), cfg)
        h = _norm(bp["ln2"], h + _mlp(bp["mlp"], h, dtype, cfg), cfg)
    else:
        h = h + _attn(bp, _norm(bp["ln1"], h, cfg), cfg, mask=mask,
                      dtype=dtype, attn_fn=attn_fn, positions=positions)
        h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def transformer_apply(params, tokens, cfg: TransformerConfig, *, mask=None,
                      dtype=torch.bfloat16, attn_fn=None, remat: bool = False,
                      head_rows=None):
    """Full-sequence forward of the decoder and encoder dialects. tokens:
    (B, S) int; mask: optional (B, S) int, 1 = valid (the encoder's
    padding mask: non-causal attention over the valid keys; a query row
    with none attends nothing and gives 0). Returns f32 logits
    (B, S, vocab), or with ``head_rows`` ((B,) positions) only the logits
    of those positions (B, vocab): the head is per position, so these are
    the same rows of the full logits without the others' head product.
    ``attn_fn`` defaults to ``ops.flash.flash_attention`` (the CUDA
    kernels on CUDA tensors, forward and backward).

    Differentiable end to end: the gradient reaches every parameter
    (embeddings, norms, projections, head) through autograd and the flash
    backward. ``remat=True`` checkpoints each block
    (``torch.utils.checkpoint``, non-reentrant), the counterpart of
    ``jax.checkpoint(body)``: the backward recomputes one block at a time
    instead of keeping every layer's activations, so the flash forward runs
    twice per layer per training step."""
    _check_dialect(cfg, encoder=True)
    attn_fn = attn_fn or flash_attention
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    h = _embed(params, tokens, positions[None, :], cfg, dtype)

    def block(bp, h):
        return _block_apply(bp, h, cfg, mask=mask, dtype=dtype,
                            attn_fn=attn_fn, positions=positions)

    for bp in params["blocks"]:
        if remat:
            h = torch.utils.checkpoint.checkpoint(block, bp, h,
                                                  use_reentrant=False)
        else:
            h = block(bp, h)
    if head_rows is not None:
        h = h[torch.arange(h.shape[0], device=h.device), head_rows]
    return _head(params, h, cfg, dtype)


def expert_parallel_params(params, mesh, axis: str = "expert"):
    """An MoE decoder's tree with each block's expert bank split over
    ``axis`` of ``mesh`` (``parallel.mesh.Mesh``): every block's ``mlp``
    becomes the ``MeshTree`` that ``place(mlp, shard_moe_params(mlp,
    mesh, axis))`` gives, every other leaf stays as it is. JAX splits
    axis 1 of its stacked (L, E, ...) banks; the port splits dim 0 of each
    block's. The forwards take the tree in place of ``params``
    (``transformer_apply`` runs its MoE layers expert-parallel)."""
    blocks = [{**bp, "mlp": place(bp["mlp"], shard_moe_params(
        bp["mlp"], mesh, axis))} for bp in params["blocks"]]
    return {**params, "blocks": blocks}


def transformer_prefill(params, tokens, caches: KVCache,
                        cfg: TransformerConfig, *, dtype=torch.bfloat16,
                        attn_mask=None, pos_ids=None, attn_fn=None):
    """Causal forward over the prompt, writing every layer's K/V at
    columns [0, S) of ``caches`` (L, B, >= S, H_kv, D), in place. Returns
    (last-column logits (B, vocab) f32, caches).

    Mixed-length batches are LEFT-padded: ``attn_mask`` (B, S) zeroes the
    pad columns and ``pos_ids`` (B, S) gives each row logical positions
    from 0 at its first real token, so every row ends at column S-1. Pad
    query rows attend nothing and give 0; their K/V land in columns the
    decode step masks (below the row's start). ``attn_fn`` defaults to
    ``ops.flash.flash_attention``: causal, the padding mask and the band.
    A ``TPParams`` model runs the tensor-parallel form over per-rank
    caches."""
    _check_dialect(cfg)
    attn_fn = attn_fn or flash_attention
    s = tokens.shape[1]
    positions = (torch.arange(s, device=tokens.device)[None, :]
                 if pos_ids is None else pos_ids)
    if isinstance(params, TPParams):
        return _tp_prefill(params, tokens, caches, cfg, dtype=dtype,
                           attn_mask=attn_mask, positions=positions,
                           attn_fn=attn_fn)
    h = _embed(params, tokens, positions, cfg, dtype)
    n_rep = cfg.n_heads // cfg.kv_heads
    for li, bp in enumerate(params["blocks"]):
        x = _norm(bp["ln1"], h, cfg)
        q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=positions)
        caches.k[li][:, :s] = k.to(caches.k.dtype)
        caches.v[li][:, :s] = v.to(caches.v.dtype)
        a = attn_fn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep), causal=True,
                    mask=attn_mask, **_band(cfg))
        h = h + nn.dense(bp["attn"]["wo"], a.reshape(*a.shape[:2], -1),
                         dtype=dtype)
        h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
        h = h.to(dtype)
    return _head(params, h[:, -1:], cfg, dtype)[:, 0], caches


def _block_decode_rows(bp, h, ck, cv, pos_vec, start_vec,
                       cfg: TransformerConfig, *, dtype, logical):
    """One decode step of one layer with per-row cache positions: ck/cv
    (B, S, H_kv, D), updated in place. Row b writes its new K/V at column
    pos_vec[b] (a column past the cache is dropped, as JAX's scatter drops
    it) and attends columns start_vec[b] <= kpos <= pos_vec[b] (inside the
    band), grouped against the unexpanded cache."""
    b = h.shape[0]
    x = _norm(bp["ln1"], h, cfg)
    q, k, v = _project_qkv(bp, x, cfg, dtype=dtype, positions=logical)
    rows = torch.arange(b, device=h.device)
    pos = pos_vec.long()
    col = torch.clamp(pos, max=ck.shape[1] - 1)
    inside = (pos < ck.shape[1])[:, None, None]
    ck[rows, col] = torch.where(inside, k[:, 0].to(ck.dtype), ck[rows, col])
    cv[rows, col] = torch.where(inside, v[:, 0].to(cv.dtype), cv[rows, col])
    kpos = torch.arange(ck.shape[1], device=h.device)[None, :]
    valid = (kpos <= pos[:, None]) & (kpos >= start_vec.long()[:, None])
    if cfg.sliding_window is not None:
        valid = valid & (kpos > pos[:, None] - cfg.sliding_window)
    a = dot_product_attention(q, ck, cv, mask=valid.to(torch.int32))
    h = h + nn.dense(bp["attn"]["wo"], a.reshape(b, 1, -1), dtype=dtype)
    h = h + _mlp(bp["mlp"], _norm(bp["ln2"], h, cfg), dtype, cfg)
    return h.to(dtype)


def transformer_decode_rows(params, token_t, caches: KVCache, pos_vec,
                            cfg: TransformerConfig, *, dtype=torch.bfloat16,
                            start_vec=None, pos_ids=None):
    """One decode step where every row has its own cache position (the
    dense scheduler's decode chunk runs ``step_chunk`` of them). token_t:
    (B,) the rows' last tokens; caches: (L, B, S, H_kv, D), updated in
    place; pos_vec: (B,) write columns; start_vec: (B,) first valid column
    per row (default 0). Rope and learned positions (clipped to the table)
    take the logical positions ``pos_ids`` (B,), by default pos - start.
    Returns (logits (B, vocab), caches)."""
    _check_dialect(cfg)
    if start_vec is None:
        start_vec = torch.zeros_like(pos_vec)
    logical = ((pos_vec - start_vec) if pos_ids is None
               else pos_ids).long()[:, None]
    h = _embed(params, token_t[:, None], logical, cfg, dtype)
    for li, bp in enumerate(params["blocks"]):
        h = _block_decode_rows(bp, h, caches.k[li], caches.v[li], pos_vec,
                               start_vec, cfg, dtype=dtype, logical=logical)
    return _head(params, h, cfg, dtype)[:, 0], caches


def transformer_decode_step(params, token_t, caches: KVCache, pos: int,
                            cfg: TransformerConfig, *, dtype=torch.bfloat16,
                            start=None, pos_ids=None):
    """One decode step of a left-padded batch at one write column ``pos``
    for every row (the batch Generator's decode loops): token_t (B,);
    caches (L, B, S, H_kv, D), updated in place; ``start`` (B,) each
    row's first valid column; ``pos_ids`` (B,) the logical positions
    (default pos - start). ``transformer_decode_rows`` with ``pos``
    broadcast to every row. A write at pos >= S is dropped (JAX's
    ``dynamic_update_slice`` clamps it onto the last column instead);
    only tokens a caller discards come from such steps. Returns
    (logits (B, vocab), caches)."""
    pos_vec = torch.full((token_t.shape[0],), int(pos), dtype=torch.int32,
                         device=token_t.device)
    return transformer_decode_rows(params, token_t, caches, pos_vec, cfg,
                                   dtype=dtype, start_vec=start,
                                   pos_ids=pos_ids)


# -- tensor-parallel serving forwards -----------------------------------------
#
# One rank per device of the group, driven from this one thread: each rank
# projects Q/K/V onto its H/N query and H_kv/N KV heads, writes its K/V into
# its own cache shard and runs its attention kernel there; its row of
# ``wo`` (and of the FFN's ``proj``) gives a partial product, and the
# ranks' partials are summed in rank order in f32 (``TPGroup.reduce_sum``)
# before the bias, added once, and the residual add. The embeddings, norms
# and the residual stream are replicated: they live on the group's home
# device (rank 0's), which every rank reads. The LM head is vocab-sharded
# where the vocab divides (logits gathered in rank order), else rank 0's
# replicated head computes it whole. An MoE block's experts are replicated
# (the rule's catch-all): the FFN runs once on the replicated input, with
# the router's expert-sharded gate gathered whole.


def tp_init_caches(cfg: TransformerConfig, group, batch: int,
                   max_seq: Optional[int] = None,
                   dtype=torch.bfloat16) -> KVCache:
    """Zeroed dense row caches for a tensor-parallel forward: rank r's
    (L, batch, max_seq, H_kv/N, D) on ``group.devices[r]``."""
    n = group.size
    shape = (cfg.n_layers, batch, max_seq or cfg.max_seq,
             cfg.kv_heads // n, cfg.d_head)
    return KVCache(
        [torch.zeros(shape, dtype=dtype, device=d) for d in group.devices],
        [torch.zeros(shape, dtype=dtype, device=d) for d in group.devices])


def _tp_mlp(bps, x, dtype, cfg: TransformerConfig, group):
    """The FFN over the group: column-parallel up-projections, the
    activation per rank, row-parallel ``proj`` partials summed; whole on
    rank 0 where ``d_ff`` does not divide (the rule replicated it); an
    MoE FFN once, on the replicated input."""
    if cfg.n_experts > 0:
        mp = dict(bps[0]["mlp"])
        gates = [bp["mlp"]["gate"]["kernel"] for bp in bps]
        if gates[0].shape[-1] != cfg.n_experts:
            mp["gate"] = dict(mp["gate"], kernel=group.gather_last(gates))
        return moe_apply(mp, x, cfg.moe, dtype=dtype)
    if bps[0]["mlp"]["proj"]["kernel"].shape[0] == cfg.d_ff:
        return _mlp(bps[0]["mlp"], x, dtype, cfg)
    parts = []
    for r, bp in enumerate(bps):
        mp, xr = bp["mlp"], group.to_rank(r, x)
        if cfg.mlp_act == "swiglu":
            hr = (nn.silu(nn.dense(mp["gate"], xr, dtype=dtype))
                  * nn.dense(mp["up"], xr, dtype=dtype))
        else:
            hr = nn.gelu(nn.dense(mp["fc"], xr, dtype=dtype),
                         approximate=cfg.gelu_tanh)
        parts.append(nn.dense(mp["proj"], hr, dtype=dtype, bias=False))
    return group.reduce_sum(parts) + bps[0]["mlp"]["proj"]["bias"]


def _tp_block(tp: TPParams, li: int, h, cfg: TransformerConfig, *, dtype,
              positions, attend):
    """One pre-LN layer over the group. ``attend(r, q, k, v)`` writes rank
    r's K/V into its cache shard and returns its heads' attention
    (B, T, H/N, D)."""
    group = tp.group
    bps = [rp["blocks"][li] for rp in tp.ranks]
    b, t = h.shape[:2]
    x = _norm(bps[0]["ln1"], h, cfg)
    parts = []
    for r, bp in enumerate(bps):
        q, k, v = _project_qkv(bp, group.to_rank(r, x), cfg, dtype=dtype,
                               positions=group.to_rank(r, positions),
                               tp=group.size)
        a = attend(r, q, k, v).to(dtype)
        parts.append(nn.dense(bp["attn"]["wo"], a.reshape(b, t, -1),
                              dtype=dtype, bias=False))
    h = h + (group.reduce_sum(parts) + bps[0]["attn"]["wo"]["bias"])
    h = h + _tp_mlp(bps, _norm(bps[0]["ln2"], h, cfg), dtype, cfg, group)
    return h.to(dtype)


def _tp_head(tp: TPParams, h, cfg: TransformerConfig, dtype):
    rp0, group = tp.ranks[0], tp.group
    if not cfg.post_ln:
        h = _norm(rp0["ln_f"], h, cfg)
    if rp0["head"]["kernel"].shape[-1] == cfg.vocab:
        return nn.dense(rp0["head"], h, dtype=dtype).float()
    return group.gather_last([
        nn.dense(rp["head"], group.to_rank(r, h), dtype=dtype)
        for r, rp in enumerate(tp.ranks)]).float()


def _tp_layer_scales(scales, r: int, li: int):
    return None if scales is None else (scales.k[r][li], scales.v[r][li])


def _tp_step_rows_ragged(tp: TPParams, tokens, caches: KVCache, tables,
                         pos0, qlen, cfg: TransformerConfig, *, dtype,
                         attn_fn, sample_slot, sample_width, scales):
    """``transformer_step_rows_ragged`` over the group: the ragged read
    launched per rank and layer on the rank's pool shard."""
    group = tp.group
    b, w = tokens.shape
    bs = caches.k[0].shape[2]
    offs = torch.arange(w, device=tokens.device)[None, :]
    logical = pos0[:, None].long() + offs                      # (B, W)
    rows = torch.arange(b, device=tokens.device)[:, None]
    cols = torch.clamp(logical, max=tables.shape[1] * bs - 1)
    blk = tables.long()[rows, cols // bs]
    blk = torch.where(offs < qlen[:, None].long(), blk, 0)
    on = [[group.to_rank(r, t) for t in (blk, cols % bs, tables, pos0, qlen)]
          for r in range(group.size)]
    h = _embed(tp.ranks[0], tokens, logical, cfg, dtype)
    for li in range(cfg.n_layers):
        def attend(r, q, k, v, li=li):
            blk_r, off_r, tables_r, pos0_r, qlen_r = on[r]
            ck, cv = caches.k[r][li], caches.v[r][li]
            sc = _tp_layer_scales(scales, r, li)
            _write_kv(ck, cv, sc, blk_r, off_r, k, v)
            if sc is None:
                return attn_fn(q, ck, cv, tables_r, pos0_r, qlen_r)
            return attn_fn(q, ck, cv, sc[0], sc[1], tables_r, pos0_r,
                           qlen_r)
        h = _tp_block(tp, li, h, cfg, dtype=dtype, positions=logical,
                      attend=attend)
    logits = _tp_head(tp, _sample_slots(h, sample_slot, sample_width), cfg,
                      dtype)
    if sample_slot is not None and sample_width == 1:
        logits = logits[:, 0]
    if scales is not None:
        return logits, caches, scales
    return logits, caches


def _tp_decode_rows_paged(tp: TPParams, token_t, caches: KVCache, tables,
                          pos_vec, cfg: TransformerConfig, *, dtype,
                          attn_fn, scales):
    """``transformer_decode_rows_paged`` over the group: the decode read
    launched per rank and layer on the rank's pool shard."""
    group = tp.group
    bs = caches.k[0].shape[2]
    rows = torch.arange(token_t.shape[0], device=token_t.device)
    pos = pos_vec.long()
    blk = tables.long()[rows, pos // bs]
    on = [[group.to_rank(r, t) for t in (blk, pos % bs, tables, pos_vec)]
          for r in range(group.size)]
    h = _embed(tp.ranks[0], token_t[:, None], pos_vec[:, None], cfg, dtype)
    for li in range(cfg.n_layers):
        def attend(r, q, k, v, li=li):
            blk_r, off_r, tables_r, pos_r = on[r]
            ck, cv = caches.k[r][li], caches.v[r][li]
            sc = _tp_layer_scales(scales, r, li)
            _write_kv(ck, cv, sc, blk_r, off_r, k[:, 0], v[:, 0])
            if sc is None:
                return attn_fn(q, ck, cv, tables_r, pos_r)
            return attn_fn(q, ck, cv, sc[0], sc[1], tables_r, pos_r)
        h = _tp_block(tp, li, h, cfg, dtype=dtype,
                      positions=pos_vec[:, None].long(), attend=attend)
    logits = _tp_head(tp, h, cfg, dtype)[:, 0]
    if scales is not None:
        return logits, caches, scales
    return logits, caches


def _tp_decode_window(tp: TPParams, tokens, caches: KVCache, pos_vec,
                      cfg: TransformerConfig, *, dtype, start_vec, head,
                      drop_past):
    """``transformer_decode_window`` over the group, each rank on its own
    row cache (``tp_init_caches``)."""
    group = tp.group
    w = tokens.shape[1]
    logical = ((pos_vec - start_vec).long()[:, None]
               + torch.arange(w, device=tokens.device)[None, :])
    on = [[group.to_rank(r, t) for t in (pos_vec, start_vec)]
          for r in range(group.size)]
    h = _embed(tp.ranks[0], tokens, logical, cfg, dtype)
    for li in range(cfg.n_layers):
        def attend(r, q, k, v, li=li):
            return _window_write_attend(q, k, v, caches.k[r][li],
                                        caches.v[r][li], *on[r], cfg,
                                        drop_past=drop_past)
        h = _tp_block(tp, li, h, cfg, dtype=dtype, positions=logical,
                      attend=attend)
    if head == "none":
        return None, caches
    if head == "last":
        h = h[:, -1:]
    return _tp_head(tp, h, cfg, dtype), caches


def _tp_prefill(tp: TPParams, tokens, caches: KVCache,
                cfg: TransformerConfig, *, dtype, attn_mask, positions,
                attn_fn):
    """``transformer_prefill`` over the group: the flash kernel per rank
    and layer on the rank's heads, K/V into the rank's cache."""
    group = tp.group
    s = tokens.shape[1]
    n_rep = cfg.n_heads // cfg.kv_heads
    masks = [None if attn_mask is None else group.to_rank(r, attn_mask)
             for r in range(group.size)]
    h = _embed(tp.ranks[0], tokens, positions, cfg, dtype)
    for li in range(cfg.n_layers):
        def attend(r, q, k, v, li=li):
            caches.k[r][li][:, :s] = k.to(caches.k[r].dtype)
            caches.v[r][li][:, :s] = v.to(caches.v[r].dtype)
            return attn_fn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                           causal=True, mask=masks[r], **_band(cfg))
        h = _tp_block(tp, li, h, cfg, dtype=dtype, positions=positions,
                      attend=attend)
    return _tp_head(tp, h[:, -1:], cfg, dtype)[:, 0], caches
