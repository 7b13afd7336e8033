"""The pixel-GP surrogates (gp/kron.py, gp/variational.py), their Adam, and
the checkpoint module (utils/checkpoint.py): port vs JAX package, f32 on the
CPU, on numpy-seeded inputs.

Tolerances. The Kronecker GP's −MLL agrees within 1e-5 relative and its
posterior mean and variance within 1e-4 of their scale: the same f32
products in another summation order. The lengthscale the sweep picks is
compared exactly, where the best two candidates' scores (float64 oracle)
stand further apart than 100 times the port's f32 error on them. After 20
Adam steps the loss histories agree within 1e-4 relative and the fitted
parameters within 1e-4 absolute. The variational GP's −ELBO agrees within
1e-5 relative and its gradient within 1e-4 of its scale; after 30 Adam steps
the losses agree within 1e-4 relative and p(y=1) within 2e-4. At the
reference's own configuration the f32 ELBO is ill-conditioned, and each
package is held to float64 within 1e-3 instead. The Adam step
itself matches ``optax.adam`` within 2e-6 over 20 steps."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from network_interpretation_imagenet_tpu.gp import kron as jkron
from network_interpretation_imagenet_tpu.gp import variational as jvar
from network_interpretation_imagenet_tpu_torch.gp import kron, variational
from network_interpretation_imagenet_tpu_torch.utils import checkpoint


def assert_close(got, want, rtol, floor=1.0):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(floor, np.abs(want).max()), (err, rtol)


def _grids():
    rng = np.random.RandomState(3)
    yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    return {
        "bump": np.exp(-((yy - 8.0) ** 2 + (xx - 6.0) ** 2) / 20.0).astype(np.float32),
        "noise": (rng.rand(24, 20) * 3.0).astype(np.float32),
        "waves": (np.outer(np.sin(np.arange(24) / 4), np.cos(np.arange(22) / 5))
                  + 0.05 * rng.rand(24, 22)).astype(np.float32),
        "counts": rng.randint(0, 30, size=(20, 20)).astype(np.float32),
    }


def _jparams(p):
    return jkron.KronGPParams(*(jnp.asarray(float(v), jnp.float32) for v in p))


# --- Kronecker pixel GP ------------------------------------------------------


@pytest.mark.parametrize("ls, os_, noise, mc", [(2.0, 1.5, 0.3, 0.2), (8.0, 0.7, 0.05, -0.4)])
def test_kron_neg_mll_posterior_offgrid_match_jax(ls, os_, noise, mc):
    y = np.random.RandomState(int(ls)).randn(14, 11).astype(np.float32)
    params = kron.init_params(ls, os_, noise, mc, device="cpu")
    jparams = jkron.init_params(ls, os_, noise, mc)
    nll = kron.neg_mll(params, y, device="cpu")
    assert_close(nll, jkron.neg_mll(jparams, jnp.asarray(y)), 1e-5)
    mean, var = kron.posterior(params, y, device="cpu")
    jmean, jvar_ = jkron.posterior(jparams, jnp.asarray(y))
    assert mean.shape == var.shape == (14, 11) and mean.dtype == torch.float32
    assert_close(mean, jmean, 1e-4)
    assert_close(var, jvar_, 1e-4)
    pts = np.random.RandomState(1).rand(9, 2).astype(np.float32) * (13, 10)
    assert_close(kron.predict_offgrid(params, y, pts, device="cpu"),
                 jkron.predict_offgrid(jparams, jnp.asarray(y), jnp.asarray(pts)), 1e-4)
    # A tensor keeps its device; a numpy grid goes where ``device`` says.
    assert_close(kron.neg_mll(params, torch.from_numpy(y)), nll, 0)


def _oracle_scores(y, grid=kron.LENGTHSCALE_GRID):
    """Every candidate's −MLL at the data-moment start, in float64."""
    y = y.astype(np.float64)
    n = y.size
    m0, v0 = y.mean(), max(y.var(), 1e-6)
    out = []
    for ls in grid:
        qh, qw, lam = (a.astype(np.float64) for a in kron._host_factored(ls, *y.shape))
        denom = v0 * lam + 0.1 * v0
        yc = qh.T @ y @ qw - m0 * np.outer(qh.sum(0), qw.sum(0))
        out.append(0.5 * ((yc * yc / denom).sum() + np.log(denom).sum() + n * np.log(2 * np.pi)))
    return np.array(out)


@pytest.mark.parametrize("name", ["bump", "noise", "waves", "counts"])
def test_kron_fit_adam_matches_jax(name):
    y = _grids()[name]
    oracle = _oracle_scores(y)
    scores = kron._sweep(*kron._factored(kron.LENGTHSCALE_GRID, *y.shape, "cpu"),
                         torch.from_numpy(y)[None])[0][0].numpy()
    err = np.abs(scores - oracle).max()
    best2 = np.sort(oracle)[:2]
    assert best2[1] - best2[0] > 100 * err, "a near-tie of the sweep: the index is not held"

    params, losses = kron.fit_adam(y, iters=20, lr=0.1, device="cpu")
    jparams, jlosses = jkron.fit_adam(y, iters=20, lr=0.1)
    want_ls = kron.LENGTHSCALE_GRID[int(np.argmin(oracle))]
    assert float(np.exp(params.log_lengthscale.item())) == pytest.approx(want_ls, rel=1e-6)
    assert float(params.log_lengthscale) == float(jparams.log_lengthscale)
    assert losses.shape == (20,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4, atol=0)
    for field in ("log_outputscale", "log_noise", "mean_const"):
        np.testing.assert_allclose(float(getattr(params, field)), float(getattr(jparams, field)),
                                   rtol=0, atol=1e-4, err_msg=field)
    mean, var = kron.posterior(params, y, device="cpu")
    jmean, jvar_ = jkron.posterior(_jparams(params), jnp.asarray(y))
    assert_close(mean, jmean, 1e-4)
    assert_close(var, jvar_, 1e-4)


def test_kron_lengthscale_selection_scale_invariant():
    """The port's twin of tests/test_gp.py::
    test_kron_lengthscale_selection_scale_invariant: a grossly mis-scaled y
    picks the same lengthscale, and Adam absorbs the scale into the
    outputscale (within half a nat of scale²)."""
    y = _grids()["waves"]
    p_ref, _ = kron.fit_adam(y, iters=8, device="cpu")
    for scale in (100.0, 0.01):
        p_s, _ = kron.fit_adam(y * scale, iters=8, device="cpu")
        assert float(p_s.log_lengthscale) == float(p_ref.log_lengthscale)
        log_ratio = float(p_s.log_outputscale - p_ref.log_outputscale)
        assert abs(log_ratio - 2 * np.log(scale)) < 0.5, log_ratio


def test_kron_fit_posterior_batch_matches_per_image_and_jax():
    """One batched program over N=3 grids equals N single fits (1e-4), and
    the JAX package's vmapped batch."""
    g = _grids()
    ys = np.stack([g["waves"][:, :20], g["noise"], np.resize(g["counts"], (24, 20))])
    params, means, vars_, losses = kron.fit_posterior_batch(ys, iters=8, device="cpu")
    jparams, jmeans, jvars, jlosses = jkron.fit_posterior_batch(ys, iters=8)
    assert means.shape == vars_.shape == ys.shape and losses.shape == (3, 8)
    for i in range(3):
        p_i, losses_i = kron.fit_adam(ys[i], iters=8, device="cpu")
        mean_i, var_i = kron.posterior(p_i, ys[i], device="cpu")
        assert float(params[i].log_lengthscale) == float(p_i.log_lengthscale)
        assert float(params[i].log_lengthscale) == float(jparams[i].log_lengthscale)
        np.testing.assert_allclose(losses[i].numpy(), losses_i.numpy(), rtol=1e-4)
        np.testing.assert_allclose(losses[i].numpy(), np.asarray(jlosses)[i], rtol=1e-4)
        assert_close(means[i], mean_i, 1e-4)
        assert_close(vars_[i], var_i, 1e-4)
        assert_close(means[i], np.asarray(jmeans)[i], 1e-4)
        assert_close(vars_[i], np.asarray(jvars)[i], 1e-4)


# --- Adam -------------------------------------------------------------------


def test_adam_step_is_optax_adam():
    """20 steps on three parameters of different shapes, both optimizers
    fed the same gradients (JAX's, along optax's trajectory): the port's
    step against optax.adam(0.1), to 2e-6 (a few f32 ulps of the
    parameters; with the bias corrections in f64 it was 1.2e-5)."""
    rng = np.random.RandomState(0)
    p0 = [np.float32(rng.randn()), rng.randn(3).astype(np.float32),
          rng.randn(2, 2).astype(np.float32)]

    def f(pp):
        a, b, c = pp
        return jnp.sin(a) * jnp.sum(b * b) + jnp.sum(jnp.cos(c)) + 0.1 * a * a

    opt = optax.adam(0.1)
    jp = tuple(jnp.asarray(v) for v in p0)
    state = opt.init(jp)
    params = [torch.from_numpy(np.array(v)) for v in p0]
    adam_state: dict = {}
    for _ in range(20):
        grads = jax.grad(f)(jp)
        updates, state = opt.update(grads, state)
        jp = optax.apply_updates(jp, updates)
        params = kron.adam_step(params, [torch.from_numpy(np.array(g)) for g in grads],
                                adam_state, 0.1)
    for got, want in zip(params, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6)


# --- variational (probit) GP -------------------------------------------------


def _vgp_problem(n=16, grid=5, seed=0):
    rng = np.random.RandomState(seed)
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    x = np.stack([yy.ravel(), xx.ravel()], -1).astype(np.float32)
    y = ((x[:, 1] + 2 * rng.randn(n * n)) >= n / 2).astype(np.float32)
    m = grid * grid
    raw = np.tril(rng.randn(m, m) * 0.1).astype(np.float32) + np.eye(m, dtype=np.float32) * 0.3
    # Lengthscale 3 against a grid spacing of 3.75: K_uu well conditioned (at
    # 5 both packages stray 2e-4 from float64, orders above their difference).
    params = (np.float32(np.log(3.0)), np.float32(0.2), (rng.randn(m) * 0.5).astype(np.float32),
              raw)
    return x, y, params


def test_vgp_model_matches_jax():
    model = variational.init_model(16, grid_size=5, lengthscale=6.0, device="cpu")
    jmodel = jvar.init_model(16, grid_size=5, lengthscale=6.0)
    np.testing.assert_allclose(model.inducing.numpy(), np.asarray(jmodel.inducing), atol=1e-6)
    for got, want in zip(model.params, jmodel.params):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_vgp_neg_elbo_and_gradient_match_jax():
    x, y, p = _vgp_problem()
    inducing = variational.make_grid_inducing(16, 5, device="cpu")
    leaves = [torch.tensor(v, requires_grad=True) for v in p]
    loss = variational.neg_elbo(variational.VGPParams(*leaves), inducing, torch.from_numpy(x),
                                torch.from_numpy(y))
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax.value_and_grad(jvar.neg_elbo)(
        jvar.VGPParams(*(jnp.asarray(v) for v in p)), jvar.make_grid_inducing(16, 5),
        jnp.asarray(x), jnp.asarray(y))
    assert_close(loss.detach(), jloss, 1e-5)
    for g, jg, name in zip(grads, jgrads, jvar.VGPParams._fields):
        jg = np.asarray(jg)
        err = np.abs(g.numpy() - jg).max()
        assert err <= 1e-4 * max(1.0, np.abs(jg).max()), (name, err)


def test_vgp_fit_adam_and_predict_match_jax():
    x, y, _ = _vgp_problem(seed=1)
    model, losses = variational.fit_adam(
        variational.init_model(16, grid_size=5, lengthscale=2.0, device="cpu"), x, y,
        iters=30, lr=0.1)
    jmodel, jlosses = jvar.fit_adam(jvar.init_model(16, grid_size=5, lengthscale=2.0), x, y,
                                    iters=30, lr=0.1)
    assert losses.shape == (30,) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    probs = variational.predict_proba(model, x)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jvar.predict_proba(jmodel, x)),
                               rtol=0, atol=2e-4)
    assert probs[x[:, 1] < 4].mean() < 0.4 < 0.6 < probs[x[:, 1] >= 12].mean()


def test_vgp_reference_configuration_f32_error():
    """At the CLI's configuration (224^2 pixels, 10 x 10 inducing points
    24.8 px apart, lengthscale 224/8, 1024 training pixels) K_uu is
    ill-conditioned in f32: both packages' −ELBO stray from the float64
    value (the port's code run in float64) by up to 5e-4 relative, orders
    above their difference on a well-conditioned problem. Each is held
    within 1e-3 of float64."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 224, size=(1024, 2)).astype(np.float32)
    y = (x[:, 0] + x[:, 1] + 40 * rng.randn(1024) > 224).astype(np.float32)
    model = variational.init_model(224, grid_size=10, lengthscale=28.0, device="cpu")
    jmodel = jvar.init_model(224, grid_size=10, lengthscale=28.0)

    def port(dt):
        params = variational.VGPParams(*(p.to(dt) for p in model.params))
        return float(variational.neg_elbo(params, model.inducing.to(dt),
                                          torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)))

    truth = port(torch.float64)
    for got in (port(torch.float32),
                float(jvar.neg_elbo(jmodel.params, jmodel.inducing, jnp.asarray(x),
                                    jnp.asarray(y)))):
        assert abs(got - truth) <= 1e-3 * abs(truth), (got, truth)


def test_vgp_fit_predict_batch_matches_per_image_and_jax():
    x, _, _ = _vgp_problem()
    ys = np.stack([_vgp_problem(seed=s)[1] for s in (2, 3, 4)])
    x_test = x[::3] + 0.5
    model = variational.init_model(16, grid_size=4, lengthscale=3.0, device="cpu")
    models, probs, losses = variational.fit_predict_batch(model, x, ys, x_test, iters=10)
    _, jprobs, jlosses = jvar.fit_predict_batch(jvar.init_model(16, grid_size=4, lengthscale=3.0),
                                                x, ys, x_test, iters=10)
    assert probs.shape == (3, len(x_test)) and losses.shape == (3, 10) and len(models) == 3
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=1e-4)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=2e-4)
    for i in range(3):
        m_i, l_i = variational.fit_adam(model, x, ys[i], iters=10)
        np.testing.assert_allclose(losses[i].numpy(), l_i.numpy(), rtol=1e-4)
        np.testing.assert_allclose(probs[i].numpy(), variational.predict_proba(m_i, x_test).numpy(),
                                   rtol=0, atol=2e-4)
        np.testing.assert_allclose(variational.predict_proba(models[i], x_test).numpy(),
                                   probs[i].numpy(), rtol=0, atol=1e-6)
    assert variational.fit_predict_batch(model, x, ys, iters=2, return_models=False)[0] is None


@pytest.mark.parametrize("which", ["kron", "variational"])
def test_gp_fit_backward_runs_in_full_f32(monkeypatch, which):
    """Each fit's autograd (the backward of the Cholesky solves and the
    kernel products) runs with TF32 off, though the process allows it, and
    the process's setting is restored afterwards."""
    seen = []
    grad = torch.autograd.grad

    def recording_grad(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return grad(*args, **kwargs)

    monkeypatch.setattr(torch.autograd, "grad", recording_grad)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if which == "kron":
            kron.fit_adam(_grids()["bump"], iters=3, device="cpu")
        else:
            x, y, _ = _vgp_problem()
            variational.fit_adam(variational.init_model(16, 4, 3.0, device="cpu"), x, y, iters=3)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False] * 3


def test_gp_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    y = np.ones((4, 5), np.float32)
    for call in (lambda: kron.fit_adam(y), lambda: kron.init_params(),
                 lambda: kron.fit_posterior_batch(y[None]),
                 lambda: variational.init_model(8, 2), lambda: variational.make_grid_inducing(8)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert kron.neg_mll(kron.init_params(device="cpu"), torch.from_numpy(y)).device.type == "cpu"


# --- checkpoints --------------------------------------------------------------


STATE = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                    "block": {"b": torch.ones(3)}},
         "epoch": 7, "arch": "resnet18", "arch_args": {"depth": 56, "mode": None},
         "note": b"bytes become text"}


def _check_state(got, epoch=7):
    np.testing.assert_array_equal(got["params"]["w"], STATE["params"]["w"])
    np.testing.assert_array_equal(got["params"]["block"]["b"], np.ones(3, np.float32))
    assert int(got["epoch"]) == epoch and got["arch"] == "resnet18"
    assert got["arch_args"] == {"depth": 56, "mode": None} and got["note"] == "bytes become text"


def test_checkpoint_roundtrip_and_best_copy(tmp_path):
    d = str(tmp_path / "ckpt")
    assert checkpoint.restore_checkpoint(d) is None
    path = checkpoint.save_checkpoint(STATE, d, is_best=True)
    assert path == os.path.join(os.path.abspath(d), "checkpoint")
    assert sorted(os.listdir(d)) == ["checkpoint", "model_best"]
    assert sorted(os.listdir(path)) == ["arrays.npz", "nit_complete", "nit_meta.json"]
    _check_state(checkpoint.restore_checkpoint(d))
    _check_state(checkpoint.restore_checkpoint(d, name="model_best"))
    checkpoint.save_checkpoint(dict(STATE, epoch=8), d)   # not best: model_best stays
    _check_state(checkpoint.restore_checkpoint(d), epoch=8)
    _check_state(checkpoint.restore_checkpoint(d, name="model_best"), epoch=7)
    with pytest.raises(ValueError, match="/"):
        checkpoint.save_checkpoint({"a/b": np.zeros(1)}, d)


@pytest.mark.parametrize("window", ["torn_new", "died_in_swap", "torn_main", "legacy"])
def test_checkpoint_crash_windows(tmp_path, window):
    """The crash windows of the swap (utils/checkpoint.py:86-98,159-169 of
    the JAX package): restore finds the one complete checkpoint, and the
    next save keeps it until its own write is complete."""
    import shutil

    d = str(tmp_path)
    main = os.path.join(d, "checkpoint")
    checkpoint.save_checkpoint(STATE, d)
    if window == "torn_new":        # died while writing .new: main is intact
        os.makedirs(main + ".new")
        want = 7
    elif window == "died_in_swap":  # main removed, the complete .new not yet renamed
        checkpoint.save_checkpoint(dict(STATE, epoch=9), d)
        shutil.copytree(main, main + ".new")
        shutil.rmtree(main)
        want = 9
    elif window == "torn_main":     # old marker dropped, rmtree cut short
        shutil.copytree(main, main + ".new")
        os.remove(os.path.join(main, "nit_complete"))
        os.remove(os.path.join(main, "arrays.npz"))
        want = 7
    else:                           # a checkpoint from before the marker
        os.remove(os.path.join(main, "nit_complete"))
        want = 7
    _check_state(checkpoint.restore_checkpoint(d), epoch=want)
    checkpoint.save_checkpoint(dict(STATE, epoch=10), d, is_best=True)
    assert sorted(os.listdir(d)) == ["checkpoint", "model_best"]
    _check_state(checkpoint.restore_checkpoint(d), epoch=10)
    _check_state(checkpoint.restore_checkpoint(d, name="model_best"), epoch=10)


def test_checkpoint_best_swap_crash_window(tmp_path):
    """A best-copy that died between removing model_best and renaming its
    marked .new: restore reads the .new, and the next best save promotes
    it before replacing it."""
    import shutil

    d = str(tmp_path)
    checkpoint.save_checkpoint(STATE, d, is_best=True)
    best = os.path.join(d, "model_best")
    shutil.copytree(best, best + ".new")
    shutil.rmtree(best)
    _check_state(checkpoint.restore_checkpoint(d, name="model_best"))
    checkpoint.save_checkpoint(dict(STATE, epoch=11), d)       # not best: .new untouched
    assert os.path.exists(best + ".new")
    checkpoint.save_checkpoint(dict(STATE, epoch=12), d, is_best=True)
    assert not os.path.exists(best + ".new")
    _check_state(checkpoint.restore_checkpoint(d, name="model_best"), epoch=12)
