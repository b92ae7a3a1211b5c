"""The port's host KV tier and chain wire format on the card: a pool on
the CUDA device keeps its host tier in pinned memory; a demote/promote
round trip is bit-exact over a bf16 pool and over an int8 pool with its
scales; a chain exported from a card pool (one block from its host tier)
imports bit-exact into another card pool and into a CPU pool. Every
test carries the ``cuda`` marker and skips where no CUDA device is
present. This file imports no jax, so the card's machine runs it without
the JAX package:

    python -m pytest --noconftest -q tests/test_torch_kv_tier_cuda.py
"""

import pytest
import torch

from tpu_engine_torch.models.registry import create_model
from tpu_engine_torch.runtime.kv_blocks import BlockPool

BS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the pinned host tier and its "
                    "copies exist only beside a CUDA pool")
    return torch.device("cuda")


def _pool(device, quantize="", blocks=10, host=4):
    return BlockPool(create_model("llama-small-test").config, blocks, BS,
                     torch.bfloat16, device, host_blocks=host,
                     quantize=quantize)


def _fill(pool, ids, seed):
    gen = torch.Generator().manual_seed(seed)
    for t in pool._pool_tensors():
        shape = (t.shape[0], len(ids)) + tuple(t.shape[2:])
        if t.dtype == torch.int8:
            src = torch.randint(-127, 128, shape, generator=gen)
        elif t.dtype == torch.float32:  # int8 scales: positive
            src = torch.rand(shape, generator=gen) + 0.01
        else:
            src = torch.randn(shape, generator=gen)
        t[:, torch.tensor(ids, device=t.device)] = src.to(t.device, t.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_host_tier_is_pinned(cuda_device, quantize):
    pool = _pool(cuda_device, quantize)
    assert len(pool._host) == (4 if quantize else 2)
    for host, t in zip(pool._host, pool._pool_tensors()):
        assert host.is_pinned() and host.device.type == "cpu"
        assert host.dtype == t.dtype
        assert tuple(host.shape) == (4, t.shape[0]) + tuple(t.shape[2:])


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_demote_promote_round_trip_is_bit_exact(cuda_device, quantize):
    pool = _pool(cuda_device, quantize)
    with pool.lock:
        ids = pool.alloc(3)
        _fill(pool, ids, seed=1)
        want = [t[:, ids].clone() for t in pool._pool_tensors()]
        toks = list(range(3 * BS))
        pool.radix.insert(toks, ids)
        pool.release_many(ids)
        assert pool.radix.evict(3) == 3 and pool.demotions == 3
        # Overwrite the freed device blocks: the bytes must come back from
        # the host tier.
        for t in pool._pool_tensors():
            t[:, ids] = 0
        got = pool.radix.lookup(toks, promote_reserve=0)
        assert len(got) == 3 and pool.swap_ins == 3
        torch.cuda.synchronize()
        for t, ref in zip(pool._pool_tensors(), want):
            assert torch.equal(t[:, got], ref)
        pool.release_many(got)
        if quantize:
            assert pool.stats()["host"]["scale_slots_leaked"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_chain_round_trip_is_bit_exact(cuda_device, quantize):
    src = _pool(cuda_device, quantize)
    dst = _pool(cuda_device, quantize)
    cpu = _pool("cpu", quantize)
    with src.lock:
        ids = src.alloc(3)
        _fill(src, ids, seed=2)
        toks = list(range(3 * BS))
        src.radix.insert(toks, ids)
        src.release_many(ids)
        want = [t[:, ids].cpu() for t in src._pool_tensors()]
        src.radix.evict(1)  # one block exports from the host tier
        chain = src.export_chain(src.radix.chain_nodes(toks))
    for pool in (dst, cpu):
        with pool.lock:
            assert pool.chain_compatible(chain) is None
            assert pool.verify_chain(chain)
            got = pool.alloc(3)
            pool.import_chain(chain, chain["blocks"], got)
            assert pool.export_chain(got) == chain
            for t, ref in zip(pool._pool_tensors(), want):
                assert torch.equal(t[:, got].cpu(), ref)
