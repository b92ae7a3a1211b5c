"""The port's training path (tpu_engine_torch.training, utils.checkpoint,
the ``train`` command and a worker serving its output) against the JAX
package's, on the CPU with the same weights and numpy-seeded batches:

- ``transformer_apply`` gradients of every parameter leaf against
  ``jax.grad`` of JAX's ``transformer_apply`` (cross entropy, f32), on the
  three small dialects, once with the JAX side through its interpreted
  flash kernels (``TPU_ENGINE_FLASH=1``); the stacked JAX leaves are
  compared layer by layer. Bound: 1e-4 relative per leaf (max|Δ| /
  max|ref|; differently ordered f32 sums through two layers).
- ``remat=True``: the same forward and gradients as without.
- ``make_train_step`` (AdamW, lr 1e-3) in both packages for three steps:
  losses within 1e-4 relative; at least 99.9% of parameter elements within
  1e-5 of JAX's and all within 3 * lr (Adam's normalisation can turn an
  f32-noise difference in a near-zero gradient into a step of up to lr).
- ``train_state_from_jax``: a JAX run's state carried across continues
  like the JAX run, within the same bounds.
- Checkpoints: save/load resumes bit-exactly; params round-trip.
- The ``train`` command in-process: the loss falls, resume continues the
  step count, the sidecar names the model, refusals; a worker built on
  ``<out>/params`` gives the greedy tokens of a generator built on the
  trained parameters; a training subprocess imports no jax.
- The repairs: the paged reads refuse inputs that require grad, and
  ``params_from_jax`` and ``init_caches`` default to the card; bf16
  training: ``dense``'s f32-output bf16 product has the JAX function's
  gradient, and a bf16 ``make_train_step`` (both packages' default dtype)
  matches the JAX package's, gradients within a few bf16 ulps."""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_engine.models import transformer as jt
from tpu_engine.models.registry import (
    _ensure_builtin_models_imported,
    create_model as jcreate,
)
from tpu_engine.training import train as jtrain
from tpu_engine_torch.models import convert, transformer as tt
from tpu_engine_torch.models.registry import create_model as tcreate
from tpu_engine_torch.ops import paged_attention as tpa
from tpu_engine_torch.runtime.scheduler import ContinuousGenerator
from tpu_engine_torch.serving import cli
from tpu_engine_torch.serving.app import serve_worker
from tpu_engine_torch.training import train as ttrain
from tpu_engine_torch.utils import checkpoint as ck
from tpu_engine_torch.utils.config import WorkerConfig

_ensure_builtin_models_imported()

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-4
LR = 1e-3
SMALL = ["gpt2-small-test", "llama-small-test", "mistral-small-test"]


def _models(name):
    spec = jcreate(name)
    params = spec.init(jax.random.PRNGKey(0))
    tcfg = tcreate(name).config
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      tcfg, device="cpu")
    return spec.config, params, tcfg, tparams


def _batch(cfg, b=2, s=24, seed=0):
    tok = np.random.default_rng(seed).integers(1, cfg.vocab, (b, s + 1))
    tok = tok.astype(np.int32)
    return tok[:, :-1], tok[:, 1:]


def _jax_leaves(tree, n_layers):
    """(path, array) of a JAX tree, the stacked blocks split per layer, in
    the port's ``tree_leaves`` order."""
    out = []
    for key in sorted(tree):
        if key == "blocks":
            for li in range(n_layers):
                out += _jax_leaves(jax.tree.map(lambda a: a[li], tree[key]),
                                   0)
        elif isinstance(tree[key], dict):
            out += _jax_leaves(tree[key], n_layers)
        else:
            out.append(np.asarray(tree[key], np.float32))
    return out


def _port_leaves(tree):
    return [t.detach().float().numpy() for t in ttrain.tree_leaves(tree)]


def _copy(tree):
    return ttrain.tree_map(torch.clone, tree)


def _leaf_names(tree, prefix=""):
    """Dotted names of a port tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _rel(got, want, floor=0.0):
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), floor, 1e-30))


def _port_grads(tparams, tcfg, x, y, remat=False):
    leaves = ttrain.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    logits = tt.transformer_apply(tparams, torch.from_numpy(x), tcfg,
                                  dtype=torch.float32, remat=remat)
    loss = ttrain.cross_entropy_loss(logits, torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    return logits.detach(), float(loss.detach()), [g.numpy() for g in grads]


def _jax_grads(params, jcfg, x, y):
    def loss(p):
        logits = jt.transformer_apply(p, jnp.asarray(x), jcfg,
                                      dtype=jnp.float32)
        return jtrain.cross_entropy_loss(logits, jnp.asarray(y))
    value, grads = jax.value_and_grad(loss)(params)
    return float(value), _jax_leaves(grads, jcfg.n_layers)


def _assert_grads_match(name):
    jcfg, params, tcfg, tparams = _models(name)
    x, y = _batch(jcfg)
    jloss, jgrads = _jax_grads(params, jcfg, x, y)
    _, tloss, tgrads = _port_grads(tparams, tcfg, x, y)
    assert abs(tloss - jloss) <= TOL * abs(jloss)
    assert len(tgrads) == len(jgrads)
    # A leaf whose gradient is 0 in exact arithmetic (the key projection's
    # bias under learned positions: softmax ignores a per-query shift of
    # the scores) holds f32 noise of ~1e-9 on both sides, so each leaf's
    # denominator is floored at 1e-3 of the largest gradient.
    floor = 1e-3 * max(float(np.max(np.abs(w))) for w in jgrads)
    for got, want in zip(tgrads, jgrads):
        assert got.shape == want.shape
        assert _rel(got, want, floor) <= TOL, _rel(got, want, floor)


@pytest.mark.parametrize("name", SMALL)
def test_apply_grads_match_jax(name):
    _assert_grads_match(name)


@pytest.mark.parametrize("name", ["llama-small-test", "mistral-small-test"])
def test_apply_grads_match_jax_flash_path(name, monkeypatch):
    """The JAX side through its Pallas flash forward and backward kernels
    (interpreted), as on a TPU."""
    monkeypatch.setenv("TPU_ENGINE_FLASH", "1")
    assert jt.default_attention().__module__ == "tpu_engine.ops.flash"
    _assert_grads_match(name)


def test_attention_projections_get_gradient():
    """Repair: a loss through transformer_apply reaches wq, wk and wv
    through the flash backward (before it, the card's output was detached
    from them)."""
    _, _, tcfg, tparams = _models("llama-small-test")
    x, y = _batch(tcfg)
    _, _, grads = _port_grads(tparams, tcfg, x, y)
    leaves = ttrain.tree_leaves(tparams)
    for w in ("wq", "wk", "wv"):
        t = tparams["blocks"][0]["attn"][w]["kernel"]
        g = grads[next(i for i, l in enumerate(leaves) if l is t)]
        assert np.abs(g).max() > 0


def test_remat_matches_no_remat():
    _, _, tcfg, tparams = _models("llama-small-test")
    x, y = _batch(tcfg)
    l0, loss0, g0 = _port_grads(tparams, tcfg, x, y, remat=False)
    l1, loss1, g1 = _port_grads(tparams, tcfg, x, y, remat=True)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-6, atol=1e-6)
    assert loss0 == loss1
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def _jax_stepper(jcfg):
    init, step = jtrain.make_train_step(
        lambda p, x, dtype=jnp.float32: jt.transformer_apply(
            p, x, jcfg, dtype=dtype),
        loss_fn=jtrain.cross_entropy_loss, optimizer=optax.adamw(LR),
        dtype=jnp.float32)
    return init, jax.jit(step)


def _port_stepper(tcfg):
    return ttrain.make_train_step(
        lambda p, x, dtype=torch.float32: tt.transformer_apply(
            p, x, tcfg, dtype=dtype),
        loss_fn=ttrain.cross_entropy_loss, optimizer=ttrain.adamw(LR),
        dtype=torch.float32)


def _assert_params_close(tstate, jstate, n_layers):
    """All elements within 3 * lr; 99.9% within 1e-5, counted over the
    leaves that have a gradient: under learned positions the key bias's
    exact gradient is 0, so its Adam step is the sign of f32 noise on
    either side (up to lr each)."""
    got = _port_leaves(tstate.params)
    want = _jax_leaves(jstate.params, n_layers)
    names = _leaf_names(tstate.params)
    diff = [np.abs(g - w).ravel() for g, w in zip(got, want)]
    assert max(float(d.max()) for d in diff) <= 3 * LR
    live = np.concatenate([d for d, n in zip(diff, names)
                           if not n.endswith("attn.wk.bias")])
    assert np.mean(live <= 1e-5) >= 0.999, np.mean(live <= 1e-5)


@pytest.mark.parametrize("name", ["gpt2-small-test", "llama-small-test"])
def test_train_steps_match_jax(name):
    jcfg, params, tcfg, tparams = _models(name)
    jinit, jstep = _jax_stepper(jcfg)
    tinit, tstep = _port_stepper(tcfg)
    jstate, tstate = jinit(params), tinit(tparams)
    for i in range(3):
        x, y = _batch(jcfg, seed=i)
        jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
        tstate, tloss = tstep(tstate, torch.from_numpy(x),
                              torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    assert tstate.step == int(jstate.step) == 3
    _assert_params_close(tstate, jstate, jcfg.n_layers)


# bf16 training (the default compute dtype of both packages' make_train_step)
# against the JAX package: per-leaf gradient bound (max|Δ| / max|ref|, the
# denominator floored as in _assert_grads_match) of 1e-2, a few bf16 ulps
# (2^-8 = 3.9e-3): both round at the same points, but bf16 einsums and the
# attention weights round sums taken in another order.
BF16_TOL = 1e-2


@pytest.mark.parametrize("shape", [(6, 32, 16), (2, 5, 64, 48)])
def test_dense_bf16_backward_matches_jax(shape):
    """Repair: dense's f32-output bf16 product is differentiable, with the
    JAX function's gradient: the f32 cotangent times the other operand in
    f32, rounded once to bf16 (then back to the f32 leaf)."""
    from tpu_engine.ops import nn as jnn
    from tpu_engine_torch.ops import nn as tnn

    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape[:-1], np.float32)
    p = {"kernel": rng.standard_normal(shape[-2:], np.float32),
         "bias": rng.standard_normal(shape[-1:], np.float32)}
    w = rng.standard_normal((*shape[:-2], shape[-1]), np.float32)

    def jloss(p, x):
        return jnp.sum(jnn.dense(p, x, dtype=jnp.bfloat16) * w)
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out = tnn.dense(tp, tx, dtype=torch.bfloat16)
    assert out.dtype == torch.float32 and out.grad_fn is not None
    (out * torch.from_numpy(w)).sum().backward()
    for got, want in ((tx.grad, jgx), (tp["kernel"].grad, jgp["kernel"]),
                      (tp["bias"].grad, jgp["bias"])):
        assert got.dtype == torch.float32
        assert _rel(got.numpy(), np.asarray(want)) <= BF16_TOL


def test_bf16_grads_and_steps_match_jax():
    """Repair: a bf16 make_train_step on llama-small-test (the port's dense
    through MatmulF32Out, attention through FlashAttention's plain
    versions) against the JAX package's make_train_step at its default
    jnp.bfloat16: every leaf's gradient within BF16_TOL, then three AdamW
    steps with losses within 1e-3 relative and every parameter within
    3 * lr."""
    jcfg, params, tcfg, tparams = _models("llama-small-test")
    x, y = _batch(jcfg)

    def loss(p):
        return jtrain.cross_entropy_loss(jt.transformer_apply(
            p, jnp.asarray(x), jcfg, dtype=jnp.bfloat16), jnp.asarray(y))
    jgrads = _jax_leaves(jax.grad(loss)(params), jcfg.n_layers)
    leaves = ttrain.tree_leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tloss = ttrain.cross_entropy_loss(tt.transformer_apply(
        tparams, torch.from_numpy(x), tcfg, dtype=torch.bfloat16),
        torch.from_numpy(y))
    tgrads = [g.numpy() for g in torch.autograd.grad(tloss, leaves)]
    floor = 1e-3 * max(float(np.max(np.abs(w))) for w in jgrads)
    for got, want in zip(tgrads, jgrads):
        assert _rel(got, want, floor) <= BF16_TOL, _rel(got, want, floor)

    jinit, jstep = jtrain.make_train_step(
        lambda p, x, dtype: jt.transformer_apply(p, x, jcfg, dtype=dtype),
        loss_fn=jtrain.cross_entropy_loss, optimizer=optax.adamw(LR))
    tinit, tstep = ttrain.make_train_step(
        lambda p, x, dtype: tt.transformer_apply(p, x, tcfg, dtype=dtype),
        loss_fn=ttrain.cross_entropy_loss, optimizer=ttrain.adamw(LR))
    jstate = jinit(params)
    tstate = tinit(ttrain.tree_map(lambda t: t.detach().clone(), tparams))
    jstep = jax.jit(jstep)
    for i in range(3):
        xb, yb = _batch(jcfg, seed=i)
        jstate, jl = jstep(jstate, jnp.asarray(xb), jnp.asarray(yb))
        tstate, tl = tstep(tstate, torch.from_numpy(xb),
                           torch.from_numpy(yb))
        assert abs(float(tl) - float(jl)) <= 1e-3 * abs(float(jl))
    got = _port_leaves(tstate.params)
    want = _jax_leaves(jstate.params, jcfg.n_layers)
    assert max(float(np.abs(g - w).max()) for g, w in zip(got, want)) \
        <= 3 * LR


def test_train_state_from_jax_continues_the_jax_run():
    jcfg, params, tcfg, _ = _models("llama-small-test")
    jinit, jstep = _jax_stepper(jcfg)
    jstate = jinit(params)
    for i in range(2):
        x, y = _batch(jcfg, seed=i)
        jstate, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                          tcfg, device="cpu")
    assert tstate.step == 2
    _, tstep = _port_stepper(tcfg)
    x, y = _batch(jcfg, seed=2)
    jstate, jloss = jstep(jstate, jnp.asarray(x), jnp.asarray(y))
    tstate, tloss = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(tloss) - float(jloss)) <= TOL * abs(float(jloss))
    assert tstate.step == 3
    leaf = ttrain.tree_leaves(tstate.params)[0]
    assert float(tstate.opt_state.state[leaf]["step"]) == 3.0
    _assert_params_close(tstate, jstate, jcfg.n_layers)


def test_train_state_checkpoint_resumes_bit_exactly(tmp_path):
    _, _, tcfg, tparams = _models("gpt2-small-test")
    tinit, tstep = _port_stepper(tcfg)
    batches = [tuple(map(torch.from_numpy, _batch(tcfg, seed=i)))
               for i in range(3)]
    straight = tinit(_copy(tparams))
    for x, y in batches:
        straight, _ = tstep(straight, x, y)
    resumed = tinit(_copy(tparams))
    for x, y in batches[:2]:
        resumed, _ = tstep(resumed, x, y)
    ck.save_train_state(tmp_path / "state", resumed)
    fresh = ck.load_train_state(tmp_path / "state",
                                like=tinit(_copy(tparams)))
    assert fresh.step == 2
    fresh, _ = tstep(fresh, *batches[2])
    assert fresh.step == 3
    for a, b in zip(ttrain.tree_leaves(fresh.params),
                    ttrain.tree_leaves(straight.params)):
        assert torch.equal(a, b)
    for a, b in zip(ttrain.tree_leaves(fresh.params),
                    ttrain.tree_leaves(straight.params)):
        sa, sb = fresh.opt_state.state[a], straight.opt_state.state[b]
        assert all(torch.equal(sa[k], sb[k])
                   for k in ("step", "exp_avg", "exp_avg_sq"))


def test_params_checkpoint_round_trips(tmp_path):
    _, _, tcfg, tparams = _models("llama-small-test")
    path = ck.save_params(tmp_path / "p", tparams)
    with pytest.raises(FileExistsError):
        ck.save_params(path, tparams)
    ck.save_params(path, tparams, overwrite=True)
    assert sorted(os.listdir(tmp_path)) == ["p"]
    got = ck.load_params(path, device="cpu")
    assert sorted(got) == sorted(tparams)
    for a, b in zip(ttrain.tree_leaves(got), ttrain.tree_leaves(tparams)):
        assert torch.equal(a, b) and not a.requires_grad
    bf = ck.load_params(path, device="cpu", dtype="bfloat16")
    assert bf["blocks"][0]["attn"]["wq"]["kernel"].dtype == torch.bfloat16
    assert bf["tok_embed"]["table"].dtype == torch.float32


def _train(args, capsys, params=None):
    rc = cli.train([*args, "--device", "cpu"], params=params)
    return rc, capsys.readouterr().out


def _losses(out):
    return [float(ln.split()[-1]) for ln in out.splitlines()
            if ln.startswith("step ")]


def test_train_command_trains_resumes_and_serves(tmp_path, capsys):
    common = ["--model", "gpt2-small-test", "--batch", "4", "--seq", "16"]
    out1 = str(tmp_path / "ck1")
    rc, out = _train([*common, "--steps", "12", "--log-every", "4", "--out",
                      out1], capsys)
    assert rc == 0, out
    losses = _losses(out)
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert "step 12:" in out

    out2 = str(tmp_path / "ck2")
    params = tcreate("gpt2-small-test").init(0, device="cpu",
                                             dtype="float32")
    rc, out = _train([*common, "--steps", "3", "--log-every", "1",
                      "--resume", os.path.join(out1, "state"), "--out",
                      out2], capsys, params=params)
    assert rc == 0, out
    assert "resumed at step 12" in out and "step 15:" in out, out
    sidecar = os.path.join(out2, "params", cli.SIDECAR)
    assert json.load(open(sidecar)) == {"model": "gpt2-small-test"}

    # A worker on <out>/params (the model named by the sidecar) gives the
    # greedy tokens of a generator built on the trained parameters.
    name, served = cli.resolve_model(os.path.join(out2, "params"),
                                     device="cpu", dtype="float32")
    assert name == "gpt2-small-test"
    worker, srv = serve_worker(WorkerConfig(
        port=0, node_id="trained", model=name, dtype="float32",
        device="cpu"), params=served)
    gen = ContinuousGenerator(
        "gpt2-small-test", device="cpu", dtype="float32", step_chunk=16,
        params=ttrain.tree_map(lambda t: t.detach(), params))
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


def test_train_command_reads_token_data(tmp_path, capsys):
    """``--data``: windows of seq + 1 tokens from random rows and offsets of
    an (N, >= seq + 1) int32 array."""
    data = tmp_path / "tokens.npy"
    np.save(data, np.random.default_rng(0).integers(
        1, 256, (6, 40)).astype(np.int32))
    rc, out = _train(["--model", "gpt2-small-test", "--steps", "2",
                      "--batch", "4", "--seq", "16", "--log-every", "1",
                      "--data", str(data)], capsys)
    assert rc == 0 and len(_losses(out)) == 2, out
    with pytest.raises(AssertionError, match="need"):
        _train(["--model", "gpt2-small-test", "--steps", "1", "--seq", "64",
                "--data", str(data)], capsys)


@pytest.mark.parametrize("args,match", [
    (["--model", "resnet50"], "is not a causal-LM transformer"),
    (["--model", "gpt2-moe"], "is not a causal-LM transformer"),
    (["--mesh", "data=2"], "--mesh (parallel training) is not yet ported"),
])
def test_train_command_refuses(args, match, capsys):
    rc, out = _train([*args, "--steps", "1"], capsys)
    assert rc == 2 and match in out


def test_training_subprocess_imports_no_jax(tmp_path):
    code = (
        "import json, sys\n"
        "from tpu_engine_torch.serving import cli\n"
        f"rc = cli.train(['--steps', '2', '--batch', '2', '--seq', '8',"
        f" '--device', 'cpu', '--out', {str(tmp_path / 'o')!r}])\n"
        "assert 'tpu_engine_torch.training.train' in sys.modules\n"
        "assert 'tpu_engine_torch.utils.checkpoint' in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'tpu_engine', 'optax', 'orbax'))\n"
        "print(json.dumps({'rc': rc, 'bad': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "rc": 0, "bad": []}


def _paged_inputs():
    ragged = [torch.from_numpy(a) for a in tpa.ragged_parity_inputs()]
    decode = [torch.from_numpy(a) for a in tpa.parity_inputs()]
    qr = [torch.from_numpy(a)
          for a in tpa.ragged_parity_inputs(quant=True)]
    qd = [torch.from_numpy(a) for a in tpa.parity_inputs(quant=True)]
    return {"ragged_paged_attention": ragged, "paged_attention": decode,
            "quant_ragged_paged_attention": qr,
            "quant_paged_attention": qd}


@pytest.mark.parametrize("name", sorted(_paged_inputs()))
def test_paged_reads_refuse_grad(name):
    """Repair: a paged read (no backward, here or in JAX) raises rather than
    return an output detached from a grad-requiring input; without grad it
    serves as before."""
    fn = getattr(tpa, name)
    args = _paged_inputs()[name]
    args[0] = args[0].requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        fn(*args)
    with torch.no_grad():
        out = fn(*args)
    ref = getattr(tpa, name + "_reference")(*[a.detach() for a in args])
    assert torch.equal(out, ref)


def test_entry_points_default_to_the_card():
    """Repair: params_from_jax and init_caches run on the card unless asked
    for the CPU; here, with no card, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    jcfg, params, tcfg, _ = _models("gpt2-small-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.init_caches(tcfg, 1, 8, torch.float32)
    assert tt.init_caches(tcfg, 1, 8, torch.float32,
                          device="cpu").k.device.type == "cpu"
