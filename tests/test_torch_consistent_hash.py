"""The port's consistent-hash ring (tpu_engine_torch.core.consistent_hash)
against the JAX package's on the same lanes and keys: FNV-1a values,
get_node over 10 000 keys, get_all_nodes (the failover order), size and
get_distribution, before and after adding and removing lanes, for several
lane sets and vnode counts. Every comparison is exact."""

import random

import pytest

from tpu_engine.core.consistent_hash import ConsistentHash as JaxRing
from tpu_engine.core.consistent_hash import fnv1a_32 as jax_fnv
from tpu_engine_torch.core.consistent_hash import ConsistentHash, fnv1a_32

LANE_SETS = {
    "reference": ["127.0.0.1:8001", "127.0.0.1:8002", "127.0.0.1:8003"],
    "localhost": ["localhost:8001", "localhost:8002", "localhost:8003"],
    "ids": [f"worker_{i}" for i in range(1, 6)],
    "one": ["10.0.0.7:9000"],
}
VNODES = (1, 16, 150)


def _keys(n=10_000, seed=0):
    rng = random.Random(seed)
    keys = [f"req_{i}" for i in range(n // 2)]
    keys += ["".join(rng.choice("abcXYZ019_-#é") for _ in range(
        rng.randint(0, 24))) for _ in range(n - len(keys))]
    return keys


def _rings(lanes, vnodes):
    port, ref = ConsistentHash(vnodes), JaxRing(vnodes)
    for lane in lanes:
        port.add_node(lane)
        ref.add_node(lane)
    return port, ref


def _same(port, ref, keys):
    assert [port.get_node(k) for k in keys] == [ref.get_node(k)
                                                for k in keys]
    assert port.get_all_nodes() == ref.get_all_nodes()
    assert port.size() == ref.size()
    assert port.get_distribution(keys) == ref.get_distribution(keys)


def test_fnv1a_matches_jax():
    for key in _keys(2000) + ["", "127.0.0.1:8001#149", "ünïcode#0"]:
        assert fnv1a_32(key) == jax_fnv(key)


@pytest.mark.parametrize("vnodes", VNODES)
@pytest.mark.parametrize("lanes", sorted(LANE_SETS))
def test_placement_matches_jax(lanes, vnodes):
    port, ref = _rings(LANE_SETS[lanes], vnodes)
    assert port.virtual_nodes == ref.virtual_nodes == vnodes
    _same(port, ref, _keys())


@pytest.mark.parametrize("vnodes", VNODES)
def test_add_and_remove_match_jax(vnodes):
    lanes = LANE_SETS["reference"]
    port, ref = _rings(lanes, vnodes)
    keys = _keys(3000, seed=1)
    for step in (("remove", lanes[1]), ("add", "127.0.0.1:8004"),
                 ("remove", lanes[0]), ("add", lanes[1]),
                 ("remove", "never-added")):
        for ring in (port, ref):
            getattr(ring, step[0] + "_node")(step[1])
        _same(port, ref, keys)
    for lane in port.get_all_nodes():
        port.remove_node(lane)
        ref.remove_node(lane)
    for ring in (port, ref):
        assert ring.get_all_nodes() == [] and ring.size() == 0
        with pytest.raises(RuntimeError, match="hash ring is empty"):
            ring.get_node("req_1")


def test_failover_order_is_ring_order_not_clockwise():
    """get_all_nodes lists lanes by their first vnode from hash 0, so the
    order does not start at a key's owner."""
    port, ref = _rings(LANE_SETS["ids"], 150)
    order = port.get_all_nodes()
    assert order == ref.get_all_nodes()
    owners = {port.get_node(k) for k in _keys(500)}
    assert owners == set(order)
    assert any(port.get_node(k) != order[0] for k in _keys(500))
