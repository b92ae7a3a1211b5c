"""SSD/Mamba-2 recurrent decoder, the state_slab family (counterpart of
``tpu_engine/models/ssd.py``; same config names, values and state layout).

A stream's whole autoregressive state is a fixed-size row: per layer, the
short conv's tail of the last ``d_conv - 1`` pre-activation inputs and the
SSM state ``(n_heads, head_dim, d_state)``, constant in sequence length
(``runtime.kv_blocks.StateSlabPool`` holds one ``(n_layers, state_dim)``
f32 row per stream).

Block = gated SSD mixer (Mamba-2 shape):

  in_proj(d_model) -> [z | x | B | C | dt]
  x -> depthwise short conv (window d_conv, cached tail) -> silu
  dt -> softplus(dt + dt_bias);  A = -exp(A_log) per head
  SSD update + D·x skip, gate · silu(z)
  RMSNorm -> out_proj -> residual

Serving runs the recurrence for prefill and decode alike
(``ssd_window_scan``): it is partition-invariant, so any chunking of a
prompt (two-path windows, mixed ticks' budgeted chunks, a replay resume)
gives the same state bits. The JAX package scans tokens (one ``lax.scan``
step per slot through every layer); the port runs the same per-token
dependency graph layer by layer: per layer ONE ``in_proj`` product over
all B·W tokens, one ``ops.ssd.ssd_scan`` (the window recurrence, a kernel
on the card), then ``gate_norm`` and ``out_proj`` over all tokens; ``ln_f``
and ``head`` run only on each row's ``sample_slot`` hidden. All mixer math
is f32, whatever the engine dtype, as in JAX (``nn.dense(...,
dtype=f32)``): the parameters are f32. ``ssd_prefill_chunked`` is the
chunked matmul form, plain PyTorch, held to the recurrence by the tests.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, NamedTuple

import torch

from tpu_engine_torch.models.registry import ModelSpec, register
from tpu_engine_torch.ops import nn
from tpu_engine_torch.ops.ssd import softplus, ssd_chunked, ssd_scan
from tpu_engine_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    vocab: int = 50257
    n_layers: int = 24
    d_model: int = 768
    d_state: int = 64        # N: SSM state width (shared across heads)
    d_conv: int = 4          # short-conv window (cached tail = d_conv - 1)
    expand: int = 2          # d_inner = expand * d_model
    n_heads: int = 8         # SSD heads over d_inner
    max_seq: int = 1024      # stream-length cap (engine limit, not memory)
    ln_eps: float = 1e-5
    ssd_chunk: int = 16      # matmul-form chunk (ssd_prefill_chunked)
    # The scheduler serves this config's streams from a state slab, never
    # a KV block chain.
    serving_state_family: ClassVar[str] = "state_slab"
    # Tensor parallelism is refused for the family: the depthwise conv
    # tail mixes channels per position with no heads axis to split, and the
    # fused slab row has no per-device partition.
    tp_partition_rule: ClassVar[str] = (
        "unshardable: the mamba2 depthwise conv tail and fused state "
        "slab rows have no heads axis to shard")
    causal: ClassVar[bool] = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        if self.d_inner % self.n_heads:
            raise ValueError(f"d_inner={self.d_inner} must divide by "
                             f"n_heads={self.n_heads}")
        return self.d_inner // self.n_heads


def ssd_state_dim(cfg: SSDConfig) -> int:
    """Flattened per-layer state width, the slab row's geometry: conv tail
    (d_conv-1, d_inner) ⧺ SSM state (H, P, N)."""
    return ((cfg.d_conv - 1) * cfg.d_inner
            + cfg.n_heads * cfg.head_dim * cfg.d_state)


class SSDState(NamedTuple):
    """Per-layer recurrent state for a batch of rows (leading layer
    axis)."""
    conv: torch.Tensor   # (L, B, d_conv - 1, d_inner)
    ssm: torch.Tensor    # (L, B, H, P, N)


def ssd_init_states(cfg: SSDConfig, batch: int, device=None) -> SSDState:
    dev = resolve_device(device)
    return SSDState(
        torch.zeros((cfg.n_layers, batch, cfg.d_conv - 1, cfg.d_inner),
                    dtype=torch.float32, device=dev),
        torch.zeros((cfg.n_layers, batch, cfg.n_heads, cfg.head_dim,
                     cfg.d_state), dtype=torch.float32, device=dev))


def flatten_states(states: SSDState) -> torch.Tensor:
    """SSDState -> (L, B, state_dim), the slab's row layout. The order
    (conv ⧺ ssm) is part of the chain wire format."""
    L, B = states.conv.shape[0], states.conv.shape[1]
    return torch.cat([states.conv.reshape(L, B, -1),
                      states.ssm.reshape(L, B, -1)], dim=-1)


def unflatten_states(flat: torch.Tensor, cfg: SSDConfig) -> SSDState:
    """(L, B, state_dim) -> SSDState (inverse of ``flatten_states``)."""
    L, B = flat.shape[0], flat.shape[1]
    split = (cfg.d_conv - 1) * cfg.d_inner
    return SSDState(
        flat[..., :split].reshape(L, B, cfg.d_conv - 1, cfg.d_inner),
        flat[..., split:].reshape(L, B, cfg.n_heads, cfg.head_dim,
                                  cfg.d_state))


def _mixer_layer(bp, h, state_l, row_ids, qlen, cfg: SSDConfig):
    """One block over every slot of the window: h (B, W, d_model) ->
    h + mixer output, state_l (R, state_dim) advanced in place at
    ``row_ids``."""
    proj = nn.dense(bp["in_proj"], nn.rmsnorm(bp["ln"], h, eps=cfg.ln_eps))
    y = ssd_scan(proj.contiguous(), state_l, row_ids, qlen, bp["conv_w"],
                 bp["conv_b"], bp["dt_bias"], bp["A_log"], bp["D"],
                 cfg.d_state, cfg.n_heads)
    y = nn.rmsnorm(bp["gate_norm"], y, eps=cfg.ln_eps)
    return h + nn.dense(bp["out_proj"], y)


@torch.no_grad()
def ssd_window_scan_rows(params, tokens, slab, row_ids, qlen, sample_slot,
                         cfg: SSDConfig):
    """The window scan over slab rows, in place: tokens (B, W) int; slab
    (L, R, state_dim) f32; row_ids, qlen (B,) int32; sample_slot (B,).
    Row r advances its slab row ``row_ids[r]`` through its first
    ``qlen[r]`` slots (a row with qlen 0 is left untouched, bit for bit:
    a done or parked row, the null row 0). Returns each row's logits at
    slot ``sample_slot[r]`` (B, vocab) f32 (not meaningful for rows whose
    sampled slot is not a valid one). ``ssd_window_scan_rows.calls``
    counts the calls: each launches the scan kernel once per layer."""
    ssd_window_scan_rows.calls += 1
    h = nn.embedding(params["tok_embed"], tokens.long()).float()
    for layer, bp in enumerate(params["blocks"]):
        h = _mixer_layer(bp, h, slab[layer], row_ids, qlen, cfg)
    rows = torch.arange(h.shape[0], device=h.device)
    hs = h[rows, sample_slot.long()]
    hs = nn.rmsnorm(params["ln_f"], hs, eps=cfg.ln_eps)
    return nn.dense(params["head"], hs)


ssd_window_scan_rows.calls = 0


def ssd_window_scan(params, tokens, states: SSDState, qlen, sample_slot,
                    cfg: SSDConfig):
    """JAX's functional form: consume up to W tokens per row from the
    rows' states, (kept logits (B, vocab), new states). tokens (B, W); row
    r advances through its first ``qlen[r]`` slots; the logits are each
    row's slot ``sample_slot[r]`` output."""
    B = tokens.shape[0]
    flat = flatten_states(states).contiguous()
    dev = flat.device
    kept = ssd_window_scan_rows(
        params, tokens.to(dev), flat,
        torch.arange(B, dtype=torch.int32, device=dev),
        torch.as_tensor(qlen, device=dev).to(torch.int32),
        torch.as_tensor(sample_slot, device=dev), cfg)
    return kept, unflatten_states(flat, cfg)


def ssd_step_rows(params, tok, states: SSDState, cfg: SSDConfig):
    """One decode step for a batch of rows: tok (B,) -> (logits (B,
    vocab) f32, new states)."""
    B = tok.shape[0]
    ones = torch.ones((B,), dtype=torch.int32)
    return ssd_window_scan(params, tok.reshape(B, 1), states, ones,
                           torch.zeros((B,), dtype=torch.long), cfg)


def ssd_step_rows_masked(params, tok, states: SSDState, valid,
                         cfg: SSDConfig):
    """``ssd_step_rows`` with per-row freezing: rows where ``valid`` is
    False keep their old state (their logits are not meaningful)."""
    B = tok.shape[0]
    qlen = torch.as_tensor(valid).to(torch.int32)
    return ssd_window_scan(params, tok.reshape(B, 1), states, qlen,
                           torch.zeros((B,), dtype=torch.long), cfg)


@torch.no_grad()
def ssd_prefill_chunked(params, tokens, cfg: SSDConfig):
    """One-shot whole-prompt prefill in the chunked matmul form, plain
    PyTorch: tokens (B, T) -> (last-position logits (B, vocab), final
    states), equal to the recurrence up to float association."""
    B, T = tokens.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    K = cfg.d_conv
    h = nn.embedding(params["tok_embed"], tokens.long()).float()
    convs, ssms = [], []
    for bp in params["blocks"]:
        x = nn.rmsnorm(bp["ln"], h, eps=cfg.ln_eps)
        proj = nn.dense(bp["in_proj"], x)
        z = proj[..., :di]
        xr = proj[..., di:2 * di]
        Bv = proj[..., 2 * di:2 * di + N]
        Cv = proj[..., 2 * di + N:2 * di + 2 * N]
        dt = proj[..., 2 * di + 2 * N:]
        # Causal depthwise conv from a zero tail (a fresh prompt).
        xp = torch.nn.functional.pad(xr, (0, 0, K - 1, 0))
        xc = sum(xp[:, k:k + T] * bp["conv_w"][k] for k in range(K)) \
            + bp["conv_b"]
        xc = torch.nn.functional.silu(xc)
        convs.append(xp[:, T:T + K - 1])
        dtp = softplus(dt + bp["dt_bias"])
        A = -torch.exp(bp["A_log"])
        xh = xc.reshape(B, T, H, P)
        y_h, final = ssd_chunked(xh, dtp, A, Bv, Cv, chunk=cfg.ssd_chunk)
        ssms.append(final)
        y = (y_h + bp["D"][None, None, :, None] * xh).reshape(B, T, di)
        y = nn.rmsnorm(bp["gate_norm"],
                       y * torch.nn.functional.silu(z), eps=cfg.ln_eps)
        h = h + nn.dense(bp["out_proj"], y)
    hl = nn.rmsnorm(params["ln_f"], h[:, -1], eps=cfg.ln_eps)
    return nn.dense(params["head"], hl), SSDState(torch.stack(convs),
                                                  torch.stack(ssms))


# -- registry ----------------------------------------------------------------

def _spec_from_config(name: str, cfg: SSDConfig, seq_len: int) -> ModelSpec:
    def init(seed, device, dtype):
        del dtype  # the mixer is f32 whatever the engine dtype
        from tpu_engine_torch.models.convert import init_ssd_params

        return init_ssd_params(cfg, seed, device)

    def apply(params, x, dtype=torch.bfloat16):
        # The one-shot /infer contract (flat float token ids -> the last
        # real position's logits), the gpt2 family's wire shape.
        tokens = torch.clamp(x, 0, cfg.vocab - 1).to(torch.int32)
        B, W = tokens.shape
        positions = torch.arange(W, device=x.device)[None, :]
        last = torch.where(tokens > 0, positions, 0).amax(dim=1)
        slab = torch.zeros((cfg.n_layers, B, ssd_state_dim(cfg)),
                           dtype=torch.float32, device=x.device)
        return ssd_window_scan_rows(
            params, tokens, slab,
            torch.arange(B, dtype=torch.int32, device=x.device),
            (last + 1).to(torch.int32), last, cfg)

    return ModelSpec(name, cfg, apply=apply, input_shape=(seq_len,),
                     output_shape=(cfg.vocab,), init_fn=init)


@register("mamba2")
def make_mamba2(seq_len: int = 128, vocab: int = 50257, n_layers: int = 24,
                d_model: int = 768, d_state: int = 64, n_heads: int = 24,
                max_seq: int = 4096) -> ModelSpec:
    """Mamba-2-shaped SSD decoder: O(1) per-stream serving state;
    max_seq caps stream length (an engine limit), never state memory."""
    cfg = SSDConfig(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    d_state=d_state, n_heads=n_heads, max_seq=max_seq)
    return _spec_from_config("mamba2", cfg, seq_len)


@register("ssd-small-test")
def make_ssd_small(seq_len: int = 16, vocab: int = 256, n_layers: int = 2,
                   d_model: int = 64, d_state: int = 16, n_heads: int = 4,
                   max_seq: int = 64) -> ModelSpec:
    """Tiny SSD config for tests: the same code path at a small size."""
    cfg = SSDConfig(vocab=vocab, n_layers=n_layers, d_model=d_model,
                    d_state=d_state, n_heads=n_heads, max_seq=max_seq)
    return _spec_from_config("ssd-small-test", cfg, seq_len)
