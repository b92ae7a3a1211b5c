"""Expert-parallel MoE of the port (``ops.moe.shard_moe_params``,
``moe_apply`` over a placed tree, ``models.transformer
.expert_parallel_params``) against the JAX package's on the same numpy
inputs.

JAX runs on the conftest's 8 virtual CPU devices, the port on
``Mesh(["cpu"] * n, (n,), ("expert",))``. The EP tests of
``tests/test_moe_pipeline.py`` have their counterparts here with JAX's
tolerances (1e-5 on the bare layer, 1e-4 on gpt2-moe-test's forward):

- ``shard_moe_params`` splits the leaves JAX's name rule splits (every
  path naming ``wi`` or ``wo``), each rank holding E/n experts;
- the expert-parallel layer against JAX's expert-sharded ``moe_apply``
  and against the port's unsharded layer (the same routed pairs and
  drops, since routing runs once on ``mesh.home``), with drops;
- an int8 expert bank split over ``expert``: JAX's ``device_put``
  refuses its 3-entry spec on the 2-D ``wi_scale``/``wo_scale``, so the
  reference is JAX's unsharded int8 layer (placement changes no math);
- the gpt2-moe-test forward with every block's bank split over 4 ranks
  against JAX's forward with its stacked banks split on axis 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.models.transformer import transformer_apply as japply
from tpu_engine.ops import moe as jmoe
from tpu_engine.ops import quant as jquant
from tpu_engine.parallel.mesh import create_mesh as jcreate_mesh
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import transformer as tt
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import moe as tmoe
from tpu_engine_torch.ops import quant as tquant
from tpu_engine_torch.parallel.mesh import (
    Mesh,
    MeshTree,
    Sharding,
    flatten_tree,
    place,
)

_ensure_builtin_models_imported()

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _moe(seed=0, **kw):
    fields = dict(d_model=16, d_ff=32, n_experts=8, top_k=2,
                  capacity_factor=2.0)
    fields.update(kw)
    cfg = jmoe.MoEConfig(**fields)
    jp = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(seed),
                                                cfg))
    tp = {"gate": {"kernel": _t(jp["gate"]["kernel"])},
          "wi": _t(jp["wi"]), "wo": _t(jp["wo"])}
    return cfg, tmoe.MoEConfig(**dataclasses.asdict(cfg)), jp, tp


def _tmesh(n):
    return Mesh(["cpu"] * n, (n,), ("expert",))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("int8", [False, True])
def test_shard_moe_params_follows_jax_name_rule(int8):
    cfg, _, jp, tp = _moe()
    if int8:
        jp = jax.tree.map(np.asarray, jquant.quantize_params(jp))
        tp = tquant.quantize_params(tp)
    mesh = _tmesh(8)
    want = jmoe.shard_moe_params(jp, jcreate_mesh((8,), ("expert",)))
    got = tmoe.shard_moe_params(tp, mesh)
    jflat = jax.tree_util.tree_flatten_with_path(want)[0]
    jsplit = {"/".join(str(getattr(k, "key", k)) for k in path):
              tuple(s.spec)[:1] == ("expert",) for path, s in jflat}
    tsplit = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            tsplit["/".join(prefix)] = node.axis == "expert"
    walk(got, ())
    assert tsplit == jsplit
    assert all(s in (Sharding(mesh, "expert", 0), Sharding(mesh))
               for s in flatten_tree(got))
    placed = place(tp, got)
    for r in range(8):
        local = placed.local(r)
        for name in ("wi", "wo") if not int8 else ("wi_q", "wi_scale",
                                                    "wo_q", "wo_scale"):
            assert local[name].shape[0] == 1     # E / n experts a rank
        assert local["gate"]["kernel"].shape == tp["gate"]["kernel"].shape


@pytest.mark.parametrize("n,cf", [(8, 2.0), (4, 0.25)],
                         ids=["expert=8", "expert=4-drops"])
def test_moe_expert_parallel_matches_jax(n, cf):
    """JAX's ``test_moe_expert_parallel_exact`` (8 experts over 8 ranks),
    and 4 ranks at a capacity that drops pairs."""
    cfg, tcfg, jp, tp = _moe(capacity_factor=cf)
    x = _x((2, 16, 16), 3)
    jmesh = jcreate_mesh((n,), ("expert",), devices=jax.devices()[:n])
    jps = jax.device_put(jax.tree.map(jnp.asarray, jp),
                         jmoe.shard_moe_params(jp, jmesh))
    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P()))
    want = np.asarray(jax.jit(lambda p, x: jmoe.moe_apply(
        p, x, cfg, dtype=jnp.float32))(jps, xs))
    placed = place(tp, tmoe.shard_moe_params(tp, _tmesh(n)))
    got = tmoe.moe_apply(placed, _t(x), tcfg, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    single = tmoe.moe_apply(tp, _t(x), tcfg, dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=LAYER_TOL,
                               atol=LAYER_TOL)
    if cf < 1:
        norms = np.linalg.norm(got.numpy().reshape(-1, 16), axis=-1)
        assert (norms < 1e-6).sum() > 0    # some tokens were dropped


def test_moe_expert_parallel_routes_once_on_home(monkeypatch):
    """Routing runs once per call, on ``mesh.home``, so the slots and the
    drops are the unsharded call's."""
    cfg, tcfg, _, tp = _moe(capacity_factor=0.5)
    x = _t(_x((2, 16, 16), 4))
    routes = []
    route = tmoe.route

    def spy(probs, cfg, n_tokens):
        d, c = route(probs, cfg, n_tokens)
        routes.append((probs.device, d))
        return d, c
    monkeypatch.setattr(tmoe, "route", spy)
    tmoe.moe_apply(tp, x, tcfg, dtype=torch.float32)
    placed = place(tp, tmoe.shard_moe_params(tp, _tmesh(4)))
    tmoe.moe_apply(placed, x, tcfg, dtype=torch.float32)
    assert len(routes) == 2
    assert torch.equal(routes[0][1], routes[1][1])
    assert routes[1][0] == placed.mesh.home


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_expert_parallel_int8(dtype):
    """An int8 bank split over ``expert`` (wi_q, wi_scale, wo_q, wo_scale
    on dim 0) against JAX's unsharded int8 layer (f32) and the port's
    unsharded int8 layer (both dtypes)."""
    cfg, tcfg, jp, tp = _moe(seed=1, capacity_factor=1.25)
    jq = jax.tree.map(np.asarray, jquant.quantize_params(jp))
    tq = tquant.quantize_params(tp)
    x = _x((2, 16, 16), 5)
    placed = place(tq, tmoe.shard_moe_params(tq, _tmesh(4)))
    dt = getattr(torch, dtype)
    got = tmoe.moe_apply(placed, _t(x), tcfg, dtype=dt)
    single = tmoe.moe_apply(tq, _t(x), tcfg, dtype=dt)
    assert torch.equal(got, single)
    if dtype == "float32":
        want = np.asarray(jmoe.moe_apply(jq, jnp.asarray(x), cfg,
                                         dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=LAYER_TOL,
                                   atol=LAYER_TOL)


def test_gpt2_moe_expert_parallel_forward_matches_jax():
    """JAX's ``test_moe_gpt_expert_parallel_forward``: gpt2-moe-test with
    its banks split over 4 ranks (JAX: axis 1 of the stacked (L, E, ...)
    tensors; the port: dim 0 of each block's bank) against JAX's
    expert-sharded forward and the port's unsharded one."""
    spec = jcreate("gpt2-moe-test")
    jp = jax.tree.map(np.asarray, spec.init(jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(2).integers(0, 256, (2, 12)).astype(
        np.int32)
    jmesh = jcreate_mesh((4,), ("expert",), devices=jax.devices()[:4])

    def spec_for(path, leaf):
        name = "/".join(str(getattr(p, "key", p)) for p in path)
        if "blocks" in name and ("wi" in name or "wo" in name) and \
                leaf.ndim == 4:
            return NamedSharding(jmesh, P(None, "expert", None, None))
        return NamedSharding(jmesh, P())

    jps = jax.device_put(jax.tree.map(jnp.asarray, jp),
                         jax.tree_util.tree_map_with_path(spec_for, jp))
    want = np.asarray(jax.jit(lambda p, t: japply(
        p, t, spec.config, dtype=jnp.float32))(jps, jnp.asarray(tokens)))
    ts = tcreate("gpt2-moe-test")
    tp = convert.params_from_jax(jp, ts.config, "cpu", "float32")
    ep = tt.expert_parallel_params(tp, _tmesh(4))
    assert all(isinstance(bp["mlp"], MeshTree) for bp in ep["blocks"])
    assert ep["blocks"][0]["mlp"].local(3)["wi"].shape[0] == \
        ts.config.n_experts // 4
    got = tt.transformer_apply(ep, _t(tokens), ts.config,
                               dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    single = tt.transformer_apply(tp, _t(tokens), ts.config,
                                  dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
