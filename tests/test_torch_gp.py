"""The port's GP (gp/kernels.py, gp/exact.py) against the JAX package's, in
f32 on the CPU, on the same numpy-seeded inputs.

Tolerances. Where K is well conditioned (lengthscales up to 2 on integer
starts) both packages compute the same f32 arithmetic in another summation
order: results agree to 1e-4 of their scale (1e-5 for the Cholesky factor,
log-determinant and MLL). From lengthscale 16 up, K ≈ all-ones + 1e-5·I
(cond ~1e6), and both packages drift from the float64 truth by
orders more than they differ in rounding; there the posterior is held within
1e-3 of its scale, the std within 5e-3, the MLL within 1e-2 relative, and the
port's carried inverse to the same accuracy class against float64 as
tests/test_gp.py holds the JAX package's (within 4x the f32 Cholesky's error
plus a floor)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from network_interpretation_imagenet_tpu.gp import exact as jexact
from network_interpretation_imagenet_tpu.gp import kernels as jkernels
from network_interpretation_imagenet_tpu_torch.gp import exact, kernels

GRID = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)
NOISE = 1e-5
WELL_CONDITIONED = (0.5, 2.0)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_close(got, want, rtol, floor=1.0):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(floor, np.abs(want).max()), (err, rtol)


def test_sq_dists_and_rbf_match_jax():
    rng = np.random.RandomState(0)
    x1, x2 = rng.randn(7, 3).astype(np.float32), rng.randn(5, 3).astype(np.float32)
    assert_close(kernels.sq_dists(t(x1), t(x2)), jkernels.sq_dists(x1, x2), 1e-5)
    for ls, os_ in ((0.7, 1.0), (3.0, 2.5)):
        assert_close(kernels.rbf_kernel(t(x1), t(x2), ls, os_),
                     jkernels.rbf_kernel(x1, x2, ls, os_), 1e-5)
    grid = np.arange(9, dtype=np.float32)
    assert_close(kernels.rbf_kernel_1d(t(grid), 2.0, 1.5), jkernels.rbf_kernel_1d(grid, 2.0, 1.5),
                 1e-6)


def test_jaccard_rbf_matches_jax():
    rng = np.random.RandomState(1)
    m1, m2 = rng.rand(4, 6, 5) > 0.5, rng.rand(3, 6, 5) > 0.4
    assert_close(kernels.jaccard_rbf_kernel(torch.from_numpy(m1), torch.from_numpy(m2), 0.8),
                 jkernels.jaccard_rbf_kernel(jnp.asarray(m1), jnp.asarray(m2), 0.8), 1e-6)


def test_full_f32_restores_the_tf32_setting():
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with kernels.full_f32():
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _observations(rng, ls, n=13, span=64):
    """Starts and targets drawn from that lengthscale's own GP prior (the
    regime in which the MLL grid would pick it; tests/test_gp.py:274)."""
    xs = rng.choice(span, size=n, replace=False).astype(np.float32)
    k = np.exp(-0.5 * ((xs[:, None] - xs[None, :]) / ls) ** 2) + 1e-6 * np.eye(n)
    return xs, (np.linalg.cholesky(k) @ rng.randn(n)).astype(np.float32)


@pytest.mark.parametrize("ls", [0.5, 2.0, 16.0, 64.0, 128.0])
@pytest.mark.parametrize("normalize_y", [True, False])
def test_fit_predict_mll_match_jax(ls, normalize_y):
    rng = np.random.RandomState(int(ls * 10))
    xs, ys = _observations(rng, ls)
    x_test = np.arange(0.0, 64.0, dtype=np.float32)[:, None]
    jp = jexact.GPParams(jnp.asarray(ls), jnp.asarray(1.0), jnp.asarray(NOISE))
    tp = exact.GPParams(torch.tensor(ls), torch.tensor(1.0), torch.tensor(NOISE))
    jfit = jexact.fit(jp, jnp.asarray(xs)[:, None], jnp.asarray(ys), normalize_y)
    tfit = exact.fit(tp, t(xs)[:, None], t(ys), normalize_y)
    jmu, jstd = jexact.predict(jfit, jnp.asarray(x_test))
    tmu, tstd = exact.predict(tfit, t(x_test))
    jmll = jexact.log_marginal_likelihood(jp, jnp.asarray(xs)[:, None], jnp.asarray(ys),
                                          normalize_y)
    tmll = exact.log_marginal_likelihood(tp, t(xs)[:, None], t(ys), normalize_y)
    if ls in WELL_CONDITIONED:
        assert_close(tfit.chol, jfit.chol, 1e-5)
        assert_close(tfit.alpha, jfit.alpha, 1e-4)
        assert_close(tmu, jmu, 1e-4)
        assert_close(tstd, jstd, 1e-4)
        assert_close(tmll, jmll, 1e-5)
    else:
        assert_close(tfit.chol, jfit.chol, 1e-3)
        assert_close(tmu, jmu, 1e-3)
        assert_close(tstd, jstd, 5e-3)
        assert_close(tmll, jmll, 1e-2)
    assert float(tfit.y_mean) == pytest.approx(float(jfit.y_mean), abs=1e-6)
    assert float(tfit.y_std) == pytest.approx(float(jfit.y_std), rel=1e-6)


def test_cholesky_failure_gives_nan_like_jax():
    """A kernel matrix that is not positive definite: NaN factor, NaN MLL."""
    x = t([[0.0], [0.0]])
    p = exact.GPParams(torch.tensor(1.0), torch.tensor(1.0), torch.tensor(-1.0))
    assert torch.isnan(exact.log_marginal_likelihood(p, x, t([0.0, 1.0]))).item()
    jp = jexact.GPParams(jnp.asarray(1.0), jnp.asarray(1.0), jnp.asarray(-1.0))
    assert np.isnan(float(jexact.log_marginal_likelihood(jp, jnp.zeros((2, 1)),
                                                         jnp.asarray([0.0, 1.0]))))
    assert exact.nanargmax(t([np.nan, 1.0, 3.0, 3.0, np.nan])).item() == 2


@pytest.mark.parametrize("seed", range(4))
def test_lengthscale_sweep_picks_the_same_index(seed):
    rng = np.random.RandomState(seed)
    n = 8
    xs = rng.choice(40, n, replace=False).astype(np.float32)
    ys = (np.exp(-0.5 * ((xs - 17.0) / (3 + seed)) ** 2) + 0.05 * rng.randn(n)).astype(np.float32)
    jfit = jexact.fit_lengthscale_sweep(jnp.asarray(xs)[:, None], jnp.asarray(ys),
                                        jnp.asarray(GRID, jnp.float32))
    tfit = exact.fit_lengthscale_sweep(t(xs)[:, None], t(ys), t(GRID))
    assert float(tfit.params.lengthscale) == float(jfit.params.lengthscale)
    assert_close(tfit.alpha, jfit.alpha, 1e-3)


def _f64_oracle(xs, yn, ls, x_test, n):
    xv, yv = xs[:n].astype(np.float64), yn[:n].astype(np.float64)
    k = np.exp(-0.5 * ((xv[:, None] - xv[None, :]) / ls) ** 2) + NOISE * np.eye(n)
    ks = np.exp(-0.5 * ((x_test[:, None].astype(np.float64) - xv[None, :]) / ls) ** 2)
    mu = ks @ np.linalg.solve(k, yv)
    var = 1.0 - np.sum(ks.T * np.linalg.solve(k, ks.T), axis=0)
    mll = -0.5 * yv @ np.linalg.solve(k, yv) - 0.5 * np.linalg.slogdet(k)[1] \
        - 0.5 * n * np.log(2 * np.pi)
    return mu, np.sqrt(np.maximum(var, 0.0)), float(mll)


@pytest.mark.parametrize("ls", [0.5, 2.0, 16.0, 64.0, 128.0])
def test_incremental_gp_matches_jax(ls):
    """Sequential bordered appends in both packages, compared at every
    observation count: the carried inverse, posterior and MLL."""
    rng = np.random.RandomState(int(ls * 10) + 1)
    m = 13
    xs_all, yn_all = _observations(rng, ls, m)
    x_test = np.arange(0.0, 64.0, dtype=np.float32)
    jstate, tstate = jexact.incremental_init(m), exact.incremental_init(m)
    xs_buf, yn_buf = np.zeros(m, np.float32), np.zeros(m, np.float32)
    for n in range(1, m + 1):
        xs_buf[n - 1], yn_buf[n - 1] = xs_all[n - 1], yn_all[n - 1]
        jstate = jexact.incremental_add(jstate, jnp.asarray(xs_buf), jnp.int32(n - 1),
                                        jnp.asarray(xs_all[n - 1]), jnp.asarray(ls), NOISE)
        tstate = exact.incremental_add(tstate, t(xs_buf), n - 1, torch.tensor(xs_all[n - 1]),
                                       torch.tensor(ls), NOISE)
        valid = (np.arange(m) < n).astype(np.float32)
        jmu, jstd = jexact.incremental_predict(jstate, jnp.asarray(xs_buf), jnp.asarray(valid),
                                               jnp.asarray(yn_buf), jnp.asarray(x_test),
                                               jnp.asarray(ls))
        tmu, tstd = exact.incremental_predict(tstate, t(xs_buf), t(valid), t(yn_buf), t(x_test),
                                              torch.tensor(ls))
        jmll = jexact.incremental_mll(jstate, jnp.asarray(yn_buf), jnp.float32(n))
        tmll = exact.incremental_mll(tstate, t(yn_buf), n)
        linv = tstate.linv.numpy()
        np.testing.assert_array_equal(linv[n:, :], np.eye(m)[n:, :])   # inactive: identity
        np.testing.assert_array_equal(linv[:n, n:], 0.0)
        np.testing.assert_array_equal(np.triu(linv[:n, :n], 1), 0.0)
        if ls in WELL_CONDITIONED:
            assert_close(linv, jstate.linv, 1e-4)
            assert_close(tstate.logdet, jstate.logdet, 1e-5)
            assert_close(tmu, jmu, 1e-4)
            # Near the noise floor (var ~ NOISE) both packages' 1 - k.K^-1.k
            # cancels in f32 to ~1e-6; sqrt magnifies that by 1/(2 std), so the
            # variance is held absolutely and the std only where std >= 1e-2.
            tvar, jvar = np.asarray(tstd, np.float64) ** 2, np.asarray(jstd, np.float64) ** 2
            assert np.abs(tvar - jvar).max() <= 5e-6
            away = np.asarray(jstd) >= 1e-2
            assert_close(np.asarray(tstd)[away], np.asarray(jstd)[away], 1e-4)
            assert_close(tmll, jmll, 1e-5)
            continue
        assert_close(tmu, jmu, 1e-3)
        assert_close(tstd, jstd, 5e-3)
        assert_close(tmll, jmll, 1e-2)
        # Accuracy class against float64, as tests/test_gp.py holds the JAX package.
        mu64, std64, mll64 = _f64_oracle(xs_buf, yn_buf, ls, x_test, n)
        fit = exact.fit(exact.GPParams(torch.tensor(ls), torch.tensor(1.0), torch.tensor(NOISE)),
                        t(xs_buf[:n])[:, None], t(yn_buf[:n]), normalize_y=False)
        mu_c, std_c = exact.predict(fit, t(x_test)[:, None])
        scale = max(1.0, float(np.abs(mu64).max()))
        assert np.abs(tmu.numpy() - mu64).max() <= \
            4 * np.abs(mu_c.numpy() - mu64).max() + 0.05 * scale
        assert np.abs(tstd.numpy() - std64).max() <= 4 * np.abs(std_c.numpy() - std64).max() + 5e-3


def test_incremental_duplicate_points_match_jax():
    """Exact duplicates (the resample rule can collide) keep the carried
    inverse finite and the posterior pinned at the data, in both packages."""
    m = 6
    xs_seq = np.asarray([3.0, 10.0, 3.0, 3.0, 10.0, 7.0], np.float32)
    yn_seq = np.asarray([1.0, -1.0, 1.0, 1.0, -1.0, 0.2], np.float32)
    jstate, tstate = jexact.incremental_init(m), exact.incremental_init(m)
    xs_buf = np.zeros(m, np.float32)
    for n in range(m):
        xs_buf[n] = xs_seq[n]
        jstate = jexact.incremental_add(jstate, jnp.asarray(xs_buf), jnp.int32(n),
                                        jnp.asarray(xs_seq[n]), jnp.asarray(2.0), NOISE)
        tstate = exact.incremental_add(tstate, t(xs_buf), n, torch.tensor(xs_seq[n]),
                                       torch.tensor(2.0), NOISE)
    assert torch.isfinite(tstate.linv).all()
    x_test = np.asarray([3.0, 10.0, 7.0], np.float32)
    tmu, tstd = exact.incremental_predict(tstate, t(xs_buf), torch.ones(m), t(yn_seq), t(x_test),
                                          torch.tensor(2.0))
    jmu, jstd = jexact.incremental_predict(jstate, jnp.asarray(xs_buf), jnp.ones(m),
                                           jnp.asarray(yn_seq), jnp.asarray(x_test),
                                           jnp.asarray(2.0))
    np.testing.assert_allclose(tmu.numpy(), [1.0, -1.0, 0.2], atol=0.05)
    assert (tstd < 0.05).all()
    assert_close(tmu, jmu, 1e-3)
    assert_close(tstd, jstd, 5e-3)


def test_incremental_batched_over_lengthscales_equals_one_at_a_time():
    """The fused loop borders all lengthscales (and images) in one call; each
    batch entry agrees with its own unbatched append."""
    m, lss = 5, torch.tensor([0.5, 2.0, 4.0])  # well conditioned: rounding only
    xs = t([4.0, 9.0, 1.0, 7.0, 2.0])
    batched = exact.incremental_init(m, (2, 3))
    single = [exact.incremental_init(m) for _ in lss]
    for n in range(m):
        buf = torch.where(torch.arange(m) <= n, xs, torch.zeros(m))
        batched = exact.incremental_add(batched, buf.expand(2, 1, m), n,
                                        xs[n].expand(2, 1), lss, NOISE)
        single = [exact.incremental_add(s, buf, n, xs[n], ls, NOISE)
                  for s, ls in zip(single, lss)]
    for i in range(3):   # batched and single matvecs may sum in another order
        for b in range(2):
            assert_close(batched.linv[b, i], single[i].linv, 1e-4)
            assert_close(batched.logdet[b, i], single[i].logdet, 1e-5)
