"""Mesh training of the port (``training.train``'s ``shard_params_tp``,
``replicated_tree``, ``make_mesh_train_step`` and ``gather_train_state``,
``parallel.mesh``'s collectives, and ``train --mesh``) against the JAX
package's mesh train step, on the CPU (every port rank on ``cpu``, JAX on
4 of its 8 virtual devices) with the same weights and numpy-seeded
batches:

- ``train --mesh data=2,model=2`` on llama-small-test gives the losses of
  JAX's jitted train step on a ``data=2,model=2`` mesh (the JAX command's
  placement: ``shard_params_tp`` over ``model``, the batch over ``data``)
  over 3 steps within 1e-4 relative, and parameters within the bounds of
  ``tests/test_torch_training.py`` (all within 3 * lr, 99.9% within
  1e-5); the same run unsharded gives the same losses;
- a placed state holds each shard's chunk of the whole leaf's moments
  (``--resume`` re-places the whole state), ``gather_train_state`` gives
  the whole state back bit for bit, and a resumed mesh run continues an
  unsharded one;
- ``--out`` then ``--resume`` continues the step count, and a worker on
  ``<out>/params`` serves a generator's greedy tokens;
- the collectives: a batch scatters and gathers in row order, gradients
  sum in rank order in f32; a batch that does not split and parameters
  split over ``data`` refuse.
"""

import contextlib
import copy
import io
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tpu_engine.models import transformer as jt
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.parallel.mesh import create_mesh as jcreate_mesh
from tpu_engine.training import train as jtrain
from tpu_engine_torch.models import convert
from tpu_engine_torch.models import transformer as tt
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.parallel.mesh import (
    Sharding,
    create_mesh,
    flatten_tree,
    place,
)
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import parse_mesh_spec, serve_worker
from tpu_engine_torch.training import train as ttrain
from tpu_engine_torch.utils import checkpoint as ck
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

MODEL = "llama-small-test"
LR = 1e-3
BATCH, SEQ, STEPS = 4, 16, 3


def _train(args, params=None):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.train([*args, "--device", "cpu"], params=params)
    return rc, buf.getvalue()


def _losses(out):
    return [float(ln.split()[-1]) for ln in out.splitlines()
            if ln.startswith("step ")]


def _port_params(jparams):
    return convert.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   tcreate(MODEL).config, "cpu", "float32")


@pytest.fixture(scope="module")
def jax_run():
    """JAX's mesh run as its train command makes it (seed 0, the fixed
    synthetic batch) on a data=2,model=2 mesh: (initial params, losses,
    final params)."""
    spec = jcreate(MODEL)
    cfg = spec.config
    mesh = jcreate_mesh(shape=(2, 2), axis_names=("data", "model"),
                        devices=jax.devices()[:4])
    init_state, train_step = jtrain.make_train_step(
        lambda p, x, dtype=jnp.float32: jt.transformer_apply(
            p, x.astype(jnp.int32), cfg, dtype=dtype),
        loss_fn=jtrain.cross_entropy_loss, optimizer=optax.adamw(LR),
        dtype=jnp.float32)
    params = spec.init(jax.random.PRNGKey(0))
    params0 = jax.tree.map(np.asarray, params)
    params = jax.device_put(params, jtrain.shard_params_tp(params, mesh,
                                                           "model"))
    state = jax.jit(init_state)(params)
    tokens = np.random.default_rng(0).integers(
        1, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    step = jax.jit(train_step)
    losses = []
    for _ in range(STEPS):
        x = jax.device_put(jnp.asarray(tokens[:, :-1], jnp.float32),
                           NamedSharding(mesh, P("data", None)))
        y = jax.device_put(jnp.asarray(tokens[:, 1:], jnp.int32),
                           NamedSharding(mesh, P("data", None)))
        state, loss = step(state, x, y)
        losses.append(float(loss))
    return params0, losses, jax.tree.map(np.asarray, state.params)


def _mesh_stepper(mesh):
    cfg = tcreate(MODEL).config
    apply_fn = (lambda p, x, dtype=torch.float32:
                tt.transformer_apply(p, x, cfg, dtype=dtype))
    init_state, step = ttrain.make_train_step(
        apply_fn, loss_fn=ttrain.cross_entropy_loss,
        optimizer=ttrain.adamw(LR), dtype=torch.float32)
    place_state, mesh_step = ttrain.make_mesh_train_step(
        apply_fn, mesh, loss_fn=ttrain.cross_entropy_loss,
        dtype=torch.float32)
    return init_state, step, place_state, mesh_step


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(1, 256, (BATCH, SEQ + 1)).astype(
        np.int64)) for _ in range(n)]


def test_train_mesh_matches_jax_mesh_step(jax_run):
    params0, jlosses, jparams = jax_run
    common = ["--model", MODEL, "--batch", str(BATCH), "--seq", str(SEQ),
              "--steps", str(STEPS), "--log-every", "1", "--lr", str(LR)]
    rc, out = _train([*common, "--mesh", "data=2,model=2"],
                     params=_port_params(params0))
    assert rc == 0, out
    losses = _losses(out)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    rc, plain = _train(common, params=_port_params(params0))
    assert _losses(plain) == losses

    # In process: unrounded losses and the final parameters.
    mesh = parse_mesh_spec("data=2,model=2", device="cpu")
    init_state, _, place_state, step = _mesh_stepper(mesh)
    full = init_state(_port_params(params0))
    state = place_state(full, ttrain.shard_params_tp(full.params, mesh))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        1, tcreate(MODEL).config.vocab, (BATCH, SEQ + 1)))
    got = []
    for _ in range(STEPS):
        state, loss = step(state, tokens[:, :-1], tokens[:, 1:])
        got.append(float(loss))
    np.testing.assert_allclose(got, jlosses, rtol=1e-4)
    whole = ttrain.gather_train_state(state).params
    want = convert.params_from_jax(jparams, tcreate(MODEL).config, "cpu",
                                   "float32")
    diff = np.concatenate([
        np.abs(a.detach().numpy() - b.numpy()).ravel() for a, b in zip(
            ttrain.tree_leaves(whole), ttrain.tree_leaves(want))])
    assert diff.max() <= 3 * LR
    assert np.mean(diff <= 1e-5) >= 0.999, np.mean(diff <= 1e-5)


@pytest.mark.parametrize("spec", ["data=2,model=2", "data=2"])
def test_placed_state_round_trips_and_continues_unsharded(spec):
    """One unsharded step, then the state placed: each shard holds its
    chunk of the leaf's moments, the gathered state is the state, and
    two mesh steps follow the unsharded run's."""
    mesh = parse_mesh_spec(spec, device="cpu")
    init_state, step, place_state, mesh_step = _mesh_stepper(mesh)
    cfg = tcreate(MODEL).config
    b0, b1, b2 = _batches(3)
    full = init_state(convert.init_params(cfg, 1, "cpu", "float32"))
    full, _ = step(full, b0[:, :-1], b0[:, 1:])
    shardings = (ttrain.shard_params_tp(full.params, mesh)
                 if "model" in mesh.shape
                 else ttrain.replicated_tree(full.params, mesh))
    # The placed state takes the given one's storage over: place a copy.
    placed = place_state(copy.deepcopy(full), shardings)
    params, opt = placed.params, placed.opt_state
    flat = flatten_tree(full.params)
    split = 0
    for i, r in params.owned():
        s, owner = params.shardings[i], params.ranks[r][i]
        whole = full.opt_state.state[flat[i]]
        for name in ("exp_avg", "exp_avg_sq"):
            want = whole[name]
            if s.axis is not None:
                want = want.chunk(mesh.shape[s.axis], s.dim)[s.shard(r)]
                split += 1
            assert torch.equal(opt.state[owner][name], want)
        assert owner.shape == (flat[i].shape if s.axis is None
                               else want.shape)
    assert (split > 0) == ("model" in mesh.shape)
    back = ttrain.gather_train_state(placed)
    for a, b in zip(ttrain.tree_leaves(back.params),
                    ttrain.tree_leaves(full.params)):
        assert torch.equal(a, b)
    for a, b in zip(ttrain.tree_leaves(back.params),
                    ttrain.tree_leaves(full.params)):
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(back.opt_state.state[a][name],
                               full.opt_state.state[b][name])
    assert back.step == full.step == 1
    for b in (b1, b2):
        placed, lm = mesh_step(placed, b[:, :-1], b[:, 1:])
        full, lu = step(full, b[:, :-1], b[:, 1:])
        assert abs(float(lm) - float(lu)) <= 1e-5 * abs(float(lu))
    assert placed.step == 3


def test_train_mesh_out_resume_and_serve(tmp_path):
    common = ["--model", MODEL, "--batch", str(BATCH), "--seq", str(SEQ),
              "--log-every", "1", "--mesh", "data=2,model=2"]
    rc, out = _train([*common, "--steps", "3", "--out",
                      str(tmp_path / "ck1")])
    assert rc == 0, out
    rc, out = _train([*common, "--steps", "2", "--resume",
                      str(tmp_path / "ck1" / "state"), "--out",
                      str(tmp_path / "ck2")])
    assert rc == 0 and "resumed at step 3" in out and "step 5:" in out, out
    resumed = _losses(out)
    rc, plain = _train(["--model", MODEL, "--batch", str(BATCH), "--seq",
                        str(SEQ), "--log-every", "1", "--steps", "5"])
    np.testing.assert_allclose(resumed, _losses(plain)[3:], rtol=1e-4)
    # The saved state is an unsharded run's: it resumes without --mesh.
    state = ck.load_train_state(str(tmp_path / "ck2" / "state"), like=(
        ttrain.make_train_step(lambda p, x, dtype: x)[0](
            tcreate(MODEL).init(0, device="cpu", dtype="float32"))))
    assert state.step == 5
    name, served = cli.resolve_model(str(tmp_path / "ck2" / "params"),
                                     device="cpu", dtype="float32")
    assert name == MODEL
    worker, srv = serve_worker(WorkerConfig(
        port=0, node_id="mesh-trained", model=name, dtype="float32",
        device="cpu"), params=served)
    gen = ContinuousGenerator(MODEL, device="cpu", dtype="float32",
                              step_chunk=16, params=ttrain.tree_map(
                                  lambda t: t.detach(), state.params))
    try:
        prompt = [5, 9, 3, 7]
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/generate",
            data=json.dumps({"request_id": "t", "prompt_tokens": prompt,
                             "max_new_tokens": 6}).encode())
        body = json.loads(urllib.request.urlopen(req, timeout=60).read())
        assert body["tokens"] == gen.generate([prompt], max_new_tokens=6)[0]
    finally:
        srv.stop()
        worker.stop()
        gen.stop()


def test_mesh_collectives_keep_rank_order():
    mesh = create_mesh(shape=(2, 3), axis_names=("model", "data"),
                       devices=["cpu"] * 6)
    x = torch.arange(12.0).reshape(6, 2)
    parts = mesh.scatter_batch(x)
    assert [p.tolist() for p in parts] == [[[0, 1], [2, 3]], [[4, 5], [6, 7]],
                                           [[8, 9], [10, 11]]]
    assert torch.equal(mesh.gather_batch(parts), x)
    g = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0]),
         torch.tensor([-1e8])]
    assert mesh.sum_f32(g, "cpu").item() == (g[0] + g[1] + g[2]).item()
    assert mesh.sum_f32(g[::-1], "cpu").item() == (
        g[2] + g[1] + g[0]).item()
    with pytest.raises(ValueError, match="does not split over data=3"):
        mesh.scatter_batch(torch.zeros(4, 2))


def test_mesh_train_refusals():
    with pytest.raises(ValueError, match="does not split over data=2"):
        _train(["--model", MODEL, "--batch", "3", "--seq", "8", "--steps",
                "1", "--mesh", "data=2"])
    mesh = parse_mesh_spec("data=2", device="cpu")
    init_state, _, place_state, _ = _mesh_stepper(mesh)
    full = init_state(tcreate(MODEL).init(0, device="cpu", dtype="float32"))
    by_data = ttrain.tree_map(lambda t: Sharding(mesh, "data", 0)
                              if t.shape[0] % 2 == 0 else Sharding(mesh),
                              full.params)
    with pytest.raises(ValueError, match="split over 'data'"):
        place_state(full, by_data)
    # Placement refuses a dim that does not split.
    with pytest.raises(ValueError, match="does not split over model=2"):
        place(torch.zeros(3, 4), Sharding(
            parse_mesh_spec("model=2", device="cpu"), "model", 0))
