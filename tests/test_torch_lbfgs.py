"""The port's L-BFGS against the JAX package's engine/lbfgs.py on the CPU:
two-loop directions on random and wrapped histories, and the strong-Wolfe
search on a smooth test function."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.engine import lbfgs as jl
from artstyletransfer_tpu_torch.engine import lbfgs as tl


def _history(rng, m, n, count):
    """Curvature pairs (s, y) with y.s > 0 written in circular order, as
    lbfgs_step stores them; count > m gives a wrapped buffer."""
    s_hist = np.zeros((m, n), np.float32)
    y_hist = np.zeros((m, n), np.float32)
    rho = np.zeros((m,), np.float32)
    for k in range(count):
        s = rng.standard_normal(n).astype(np.float32)
        y = (s * rng.uniform(0.5, 2.0, n) + 0.1 * rng.standard_normal(n)
             ).astype(np.float32)
        i = k % m
        s_hist[i], y_hist[i] = s, y
        rho[i] = 1.0 / np.dot(y, s)
    return s_hist, y_hist, rho


@pytest.mark.parametrize("impl", ["matrix", "loop"])
@pytest.mark.parametrize("m,count", [(5, 0), (5, 3), (5, 5), (5, 12),
                                     (3, 7)])
def test_two_loop_direction_matches_jax(rng, impl, m, count):
    """rtol 1e-4 (atol 1e-4 of the largest entry): the same float32
    recursion, dot products summed in different orders."""
    n = 64
    s_hist, y_hist, rho = _history(rng, m, n, count)
    g = rng.standard_normal(n).astype(np.float32)
    jstate = jl.LbfgsState(
        s_hist=jnp.asarray(s_hist), y_hist=jnp.asarray(y_hist),
        rho=jnp.asarray(rho), count=jnp.int32(count), f=jnp.float32(0.0),
        g=jnp.asarray(g), n_evals=jnp.int32(1), n_iter=jnp.int32(count))
    ref = np.asarray(jl._two_loop_direction(jnp.asarray(g), jstate, impl=impl))
    tstate = tl.LbfgsState(
        s_hist=torch.from_numpy(s_hist), y_hist=torch.from_numpy(y_hist),
        rho=torch.from_numpy(rho), count=count, f=np.float32(0.0),
        g=torch.from_numpy(g), n_evals=1, n_iter=count)
    ours = tl._two_loop_direction(torch.from_numpy(g), tstate,
                                  impl=impl).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    if count == 0:
        np.testing.assert_array_equal(ours, -g)


def test_direction_forms_agree(rng):
    s_hist, y_hist, rho = _history(rng, 4, 32, 9)
    g = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    st = tl.LbfgsState(torch.from_numpy(s_hist), torch.from_numpy(y_hist),
                       torch.from_numpy(rho), 9, np.float32(0), g, 1, 9)
    a = tl._two_loop_direction(g, st, impl="matrix")
    b = tl._two_loop_direction(g, st, impl="loop")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        tl._two_loop_direction(g, st, impl="nope")


_A = np.random.default_rng(0).standard_normal(40).astype(np.float32)


def _jax_fn(x):
    return jnp.sum((x - _A) ** 4) + jnp.sum(jnp.sin(3 * x))


def _torch_loss_grad(x):
    x = x.detach().requires_grad_(True)
    f = torch.sum((x - torch.from_numpy(_A)) ** 4) + torch.sum(torch.sin(3 * x))
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


@pytest.mark.parametrize("t_init", [1e-3, 0.01, 0.1, 0.5, 1.0, 3.0, 10.0])
def test_strong_wolfe_matches_jax(t_init):
    """Bracket and zoom phases (large trial steps overshoot and zoom;
    small ones are accepted at once) make the same decisions: same number
    of evaluations, step and loss within float32 rounding. (Extrapolation
    from a tiny step can branch on a cubic discriminant that cancels to
    rounding noise, so such starts are not compared here.)"""
    x = np.random.default_rng(int(t_init * 1000)).standard_normal(40).astype(
        np.float32)
    lg = jax.value_and_grad(_jax_fn)
    f0, g0 = lg(jnp.asarray(x))
    jt, jf, _jg, jn = jl._strong_wolfe(lg, jnp.asarray(x), -g0, f0, g0,
                                       jnp.float32(t_init), 25)
    tf0, tg0 = _torch_loss_grad(torch.from_numpy(x))
    t, f, _g, n = tl._strong_wolfe(_torch_loss_grad, torch.from_numpy(x),
                                   -tg0, np.float32(tf0.item()), tg0,
                                   np.float32(t_init), 25)
    assert n == int(jn)
    np.testing.assert_allclose(t, float(jt), rtol=1e-4)
    np.testing.assert_allclose(f, float(jf), rtol=1e-4)


def test_lbfgs_step_minimizes_and_fills_history():
    x = torch.zeros(40)
    state = tl.init_state(_torch_loss_grad, x, history=3)
    f_start = state.f
    for _ in range(6):
        x, state = tl.lbfgs_step(_torch_loss_grad, x, state, 1.0)
    assert state.f < f_start
    assert state.count == 6 and state.n_iter == 6
    assert state.n_evals >= 7
    f_check, _ = _torch_loss_grad(x)
    np.testing.assert_allclose(float(f_check), state.f, rtol=1e-6)
