"""Sequence parallelism of the port (counterpart of
``tpu_engine/parallel/ring.py``): ring attention and Ulysses all-to-all
attention over a ``seq`` axis of a ``parallel.mesh.Mesh``.

q, k, v are (B, S, H, D) with S split over ``axis_name`` in equal
contiguous chunks: rank r holds the chunk ``mesh.coords(r)[axis_name]``
on ``mesh.devices[r]``. They are given whole (the result comes back whole
on q's device) or placed by ``place(x, seq_sharding(mesh))`` (a
``MeshTree`` of one leaf; the result comes back placed alike). One
process drives every rank, as JAX's single controller does; the JAX
collectives become explicit copies between the ranks' devices.

- **Ring** (``ring_attention``): rank ``my`` keeps its q chunk and meets
  every K/V chunk in the ring's order, at hop t the one that started on
  rank ``src = (my - t) mod n`` (JAX's ``ppermute`` to the next rank, one
  hop at a time). Its mask chunk rides with it. Exact, not an
  approximation:
  - on CPU tensors each hop is ``_online_block``, JAX's accumulation
    step transcribed (scores in the inputs' dtype, then f32; running max
    and denominator in f32; ``p @ v`` in f32), and ``_finalize`` casts
    the f32 accumulator to v's dtype;
  - on CUDA tensors each hop is one call of the flash forward
    (``ops.flash.flash_attention_fwd``, #5), which returns the hop's
    output in f32, unrounded, and its f32 log-sum-exp; ``merge_hops``
    weighs the hops' outputs by their lse in f32 and rounds the result to
    v's dtype once, as JAX keeps ``o`` in f32 across hops. The hop is causal on the diagonal chunk
    (``src == my``), unmasked by position below it (``src < my``) and
    skipped above it (``src > my``: JAX's step leaves o, m and l as they
    were there). This path is forward-only: it refuses inputs that
    require grad, where the CPU path is differentiable through autograd.
- **Ulysses** (``ulysses_attention``): the all-to-all re-slices, so rank
  i holds the whole sequence for heads [i·H/n, (i+1)·H/n) and the mask is
  all-gathered; each rank runs ``ops.flash.flash_attention`` (#5 on CUDA
  tensors, its plain version on the CPU) and the heads come back in rank
  order.

``batch_axis`` splits B over another axis: each slice along it runs a
ring of its own. Ranks at another coordinate of any further axis hold
copies and compute nothing; with placed inputs they receive the result
of the rank at 0 on those axes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch

from tpu_engine_torch.ops import flash
from tpu_engine_torch.parallel.mesh import Mesh, MeshTree, Sharding

_NEG_INF = float("-inf")


# -- the plain ring (CPU tensors): JAX's accumulation step -------------------


def _online_block(q, k, v, o, m, l, *, qpos, kpos, kv_mask):
    """One blockwise accumulation step (JAX's ``_online_block``).
    q: (B, Sq, H, D); k, v: (B, Sk, H, D); o: (B, H, Sq, D) f32; m, l:
    (B, H, Sq) f32 running max and denominator; qpos: (Sq,) global query
    positions or None (no causal mask); kpos: (Sk,) the block's global key
    positions; kv_mask: (B, Sk), 1 = valid, or None."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    s = s / math.sqrt(d)
    if qpos is not None:
        s = torch.where(qpos[None, None, :, None] >= kpos[None, None, None, :],
                        s, _NEG_INF)
    if kv_mask is not None:
        s = torch.where(kv_mask[:, None, None, :] > 0, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    # A row masked so far has m_new == -inf: exp(s - 0) of its -inf
    # scores is 0, the right answer.
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    # Such rows carry o = l = 0: force the factor to 0 (no inf - inf).
    corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l_new = l * corr + p.sum(-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v.float())
    return o_new, m_new, l_new


def _finalize(o, l, out_dtype):
    """o (B, H, Sq, D) f32, l (B, H, Sq) -> (B, Sq, H, D) in out_dtype."""
    out = o / torch.where(l == 0.0, 1.0, l)[..., None]
    return out.transpose(1, 2).to(out_dtype)


def _plain_ring(q, kv, my: int, n: int, chunk: int, causal: bool):
    """Rank ``my``'s output over the ring by ``_online_block``; ``kv(src)``
    gives the chunk that started on rank src, on ``my``'s device."""
    b, sq, h, d = q.shape
    dev = q.device
    qpos = my * chunk + torch.arange(sq, device=dev) if causal else None
    o = torch.zeros((b, h, sq, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    v_dtype = None
    for t in range(n):
        src = (my - t) % n
        k, v, mask = kv(src)
        v_dtype = v.dtype
        kpos = src * chunk + torch.arange(k.shape[1], device=dev)
        o, m, l = _online_block(q, k, v, o, m, l, qpos=qpos, kpos=kpos,
                                kv_mask=mask)
    return _finalize(o, l, v_dtype)


# -- the card's ring: one flash forward a hop, merged by lse ------------------


HopBlock = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
# ``_ring``'s block for the plain ring (``_online_block``) on any device:
# the card's check of the merged ring against it.
PLAIN = "plain"


def merge_hops(q, kv, my: int, n: int, *, causal: bool,
               block: HopBlock = flash.flash_attention_fwd):
    """Rank ``my``'s ring output from one ``block(q, k, v, causal=...,
    mask=..., out_dtype=torch.float32)`` call a hop, each returning (out
    (B, Sq, H, D) f32, unrounded, lse (B, H, Sq) f32) as the flash forward
    does; ``kv(src)`` gives the K/V chunk
    (and its mask chunk or None) that started on rank src. Under
    ``causal`` the diagonal hop is causal, a hop from an earlier rank
    attends every key, and one from a later rank is skipped. The hops'
    outputs are weighed in f32 by exp(lse - the running max of lse); a
    row masked in every hop gives 0. Returns (B, Sq, H, D) in v's
    dtype."""
    o = m = l = None
    v_dtype = None
    for t in range(n):
        src = (my - t) % n
        if causal and src > my:
            continue
        k, v, mask = kv(src)
        v_dtype = v.dtype
        out, lse = block(q, k, v, causal=causal and src == my, mask=mask,
                         out_dtype=torch.float32)
        if o is None:
            o, m, l = (torch.zeros_like(out),
                       torch.full_like(lse, _NEG_INF), torch.zeros_like(lse))
        m_new = torch.maximum(m, lse)
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe))
        w = torch.exp(lse - safe)  # 0 where the hop's row is masked
        l = l * corr + w
        o = (o * corr.transpose(1, 2)[..., None]
             + out * w.transpose(1, 2)[..., None])
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)[..., None]).to(v_dtype)


# -- shards --------------------------------------------------------------------


def seq_sharding(mesh: Mesh, axis_name: str = "seq", ndim: int = 4,
                 batch_axis: Optional[str] = None
                 ) -> Union[Sharding, Tuple[Sharding, Sharding]]:
    """Dim 1 (the sequence) split over ``axis_name``: JAX's
    ``NamedSharding(mesh, P(batch_axis, axis_name, None, ...))``. A port
    ``Sharding`` splits one dim over one axis, so with ``batch_axis`` the
    two-axis spec is the pair of one-axis Shardings, outermost dim first
    (dim 0 over ``batch_axis``, dim 1 over ``axis_name``): the cuts that
    ``ring_attention`` and ``ulysses_attention`` make of whole inputs.
    ``place`` takes the single Sharding; ``ndim`` is kept for JAX's
    signature (the spec names dims 0 and 1 only)."""
    if ndim < 2:
        raise ValueError(f"a sequence sharding needs ndim >= 2, got {ndim}")
    seq = Sharding(mesh, axis_name, 1)
    return seq if batch_axis is None else (Sharding(mesh, batch_axis, 0),
                                           seq)


def _groups(mesh: Mesh, axis_name: str, batch_axis: Optional[str]):
    """The computing ranks: for each slice j along ``batch_axis`` (one
    when None), the ranks of its ring in chunk order, at 0 on every other
    axis."""
    nb = mesh.shape[batch_axis] if batch_axis is not None else 1
    return [[mesh.rank(**{axis_name: i,
                          **({batch_axis: j} if batch_axis else {})})
             for i in range(mesh.shape[axis_name])] for j in range(nb)]


def _run(q, k, v, kv_mask, mesh: Mesh, axis_name: str,
         batch_axis: Optional[str], rank_fn):
    """Cut whole or placed inputs into the ranks' chunks, run ``rank_fn``
    (one call per batch slice: chunks of q, k, v and the mask per ring
    position, each on its rank's device -> the ring's output chunks), and
    return the output as the inputs came."""
    placed = isinstance(q, MeshTree)
    if placed:
        for t in (q, k, v) + ((kv_mask,) if kv_mask is not None else ()):
            if not isinstance(t, MeshTree) or [
                    (s.axis, s.dim) for s in t.shardings] != [(axis_name, 1)]:
                raise ValueError(
                    f"placed inputs must each be one leaf split on dim 1 "
                    f"over {axis_name!r} (place(x, seq_sharding(mesh)))")
        if batch_axis is not None:
            raise ValueError("placed inputs split the sequence only; pass "
                             "whole tensors with batch_axis")
        shape = q.ranks[0][0].shape
        b, s = shape[0], shape[1] * mesh.shape[axis_name]
    else:
        b, s = q.shape[0], q.shape[1]
    n = mesh.shape[axis_name]
    if s % n != 0:
        raise ValueError(f"seq len {s} not divisible by {axis_name}={n}")
    nb = mesh.shape[batch_axis] if batch_axis is not None else 1
    if b % nb != 0:
        raise ValueError(f"batch {b} not divisible by {batch_axis}={nb}")
    groups = _groups(mesh, axis_name, batch_axis)
    outs = []
    for j, ranks in enumerate(groups):
        def chunks(x):
            if x is None:
                return [None] * n
            if placed:
                return [x.ranks[r][0] for r in ranks]
            xb = x.chunk(nb, 0)[j]
            return [xb.chunk(n, 1)[i].to(mesh.devices[r])
                    for i, r in enumerate(ranks)]
        outs.append(rank_fn(ranks, chunks(q), chunks(k), chunks(v),
                            chunks(kv_mask)))
    if placed:
        per_rank = {r: o for ranks, os in zip(groups, outs)
                    for r, o in zip(ranks, os)}
        # A rank off the computing set holds the copy of the rank at its
        # chunk and 0 on every other axis.
        return q.with_ranks([[per_rank[mesh.rank(**{
            axis_name: mesh.coords(r)[axis_name]})].to(mesh.devices[r])]
            for r in range(mesh.size)])
    return torch.cat([torch.cat([o.to(q.device) for o in os], 1)
                      for os in outs], 0)


def _check_grad(*ts) -> None:
    """The merged ring has no backward: refuse inputs that would need
    one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "ring_attention over the flash forward (CUDA tensors) is "
            "forward-only: one flash forward a hop, merged by lse, with no "
            "backward; call it under torch.no_grad(), or on CPU tensors, "
            "whose ring is differentiable")


def ring_attention(q, k, v, mesh: Mesh, *, axis_name: str = "seq",
                   causal: bool = False, kv_mask=None,
                   batch_axis: Optional[str] = None):
    """Exact attention over sequences split on ``axis_name`` (JAX's
    contract). q, k, v: (B, S, H, D), whole or placed by ``place(x,
    seq_sharding(mesh))``; S divides by the axis size. kv_mask: optional
    (B, S) padding mask, 1 = valid, split like them. ``batch_axis``:
    optional axis splitting B, each slice its own ring. Returns (B, S, H,
    D) in v's dtype, whole on q's device or placed like q."""
    return _ring(q, k, v, mesh, axis_name=axis_name, causal=causal,
                 kv_mask=kv_mask, batch_axis=batch_axis)


def _ring(q, k, v, mesh: Mesh, *, axis_name: str, causal: bool, kv_mask,
          batch_axis: Optional[str],
          block: Union[None, str, HopBlock] = None):
    """``ring_attention`` with the hop's block chosen: None = by each
    rank's device (the plain ring on the CPU, ``merge_hops`` over the flash
    forward on CUDA); ``PLAIN`` = the plain ring on every rank (what the
    card's merge is held against); a function = ``merge_hops`` over it on
    every rank (the CPU tests hold the card's merge against JAX with the
    flash forward's plain version)."""
    n = mesh.shape[axis_name]

    def rank_fn(ranks, qs, ks, vs, ms):
        chunk = qs[0].shape[1]
        outs = []
        for my, r in enumerate(ranks):
            dev = mesh.devices[r]

            def kv(src):
                m = ms[src]
                return (ks[src].to(dev), vs[src].to(dev),
                        None if m is None else m.to(dev))
            if block == PLAIN or (block is None and dev.type == "cpu"):
                outs.append(_plain_ring(qs[my], kv, my, n, chunk, causal))
                continue
            _check_grad(qs[my], ks[my], vs[my])
            outs.append(merge_hops(
                qs[my], kv, my, n, causal=causal,
                block=block or flash.flash_attention_fwd))
        return outs
    return _run(q, k, v, kv_mask, mesh, axis_name, batch_axis, rank_fn)


def ulysses_attention(q, k, v, mesh: Mesh, *, axis_name: str = "seq",
                      causal: bool = False, kv_mask=None,
                      batch_axis: Optional[str] = None):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention, with
    ``ring_attention``'s contract; n_heads divides by the axis size. Rank
    i attends the whole sequence for its H/n heads through
    ``ops.flash.flash_attention``."""
    n = mesh.shape[axis_name]
    h = (q.ranks[0][0] if isinstance(q, MeshTree) else q).shape[2]
    if h % n != 0:
        raise ValueError(f"n_heads {h} not divisible by {axis_name}={n}")

    def rank_fn(ranks, qs, ks, vs, ms):
        hn = h // n
        mask = None
        if ms[0] is not None:
            mask = [Mesh.gather(ms, 1, mesh.devices[r]) for r in ranks]
        heads = []
        for i, r in enumerate(ranks):
            dev = mesh.devices[r]
            qf, kf, vf = (Mesh.gather([c[:, :, i * hn:(i + 1) * hn]
                                       for c in cs], 1, dev)
                          for cs in (qs, ks, vs))
            heads.append(flash.flash_attention(
                qf, kf, vf, causal=causal,
                mask=None if mask is None else mask[i]))
        # Back to sequence chunks: rank i's chunk of every rank's heads.
        c = heads[0].shape[1] // n
        return [Mesh.gather([a[:, i * c:(i + 1) * c] for a in heads], 2,
                            mesh.devices[r]) for i, r in enumerate(ranks)]
    return _run(q, k, v, kv_mask, mesh, axis_name, batch_axis, rank_fn)
