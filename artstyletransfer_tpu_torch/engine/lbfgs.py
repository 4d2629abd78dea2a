"""L-BFGS with a strong-Wolfe line search, as a host-driven loop on device
tensors.

A port of the JAX package's ``engine/lbfgs.py``, which follows torch's
``LBFGS(max_iter=1, line_search_fn='strong_wolfe')`` decision for
decision: the same cubic-interpolation bounds, the ls_iter>1 re-bracketing
quirk, the insufficient-progress nudging and the lowest-f bracket
bookkeeping, and torch's pre-search break (a direction whose slope is not
below -tolerance_change makes the step a no-op). Like the JAX package it
carries (f, g) of the accepted point in the state instead of re-evaluating
it at the top of the next step. It does not use ``torch.optim.LBFGS``,
whose step re-evaluates the closure and runs its own lr schedule.

The vectors (x, g, the (m, n) history) live on the device; the line
search's decisions run on the host on float32 scalars (numpy), one
device->host read of (f, g.d) per evaluation. The history buffers are
updated in place (one row per accepted step) instead of being copied.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

# Wolfe constants and tolerances (torch's values).
_C1 = 1e-4
_C2 = 0.9
_TOL_CHANGE = 1e-9

_f32 = np.float32

LossGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class LbfgsState:
    s_hist: torch.Tensor  # (m, n) parameter-difference history
    y_hist: torch.Tensor  # (m, n) gradient-difference history
    rho: torch.Tensor     # (m,)   1 / (y . s)
    count: int            # number of pairs ever stored
    f: np.float32         # loss at the current point
    g: torch.Tensor       # (n,)   gradient at the current point
    n_evals: int          # cumulative loss/grad evaluations
    n_iter: int           # completed lbfgs_step calls (torch n_iter)


def init_state(loss_grad: LossGradFn, x: torch.Tensor, history: int,
               track_grams: bool = False, state_dtype=None) -> LbfgsState:
    """Initial state; performs the first loss/grad evaluation.

    track_grams (carried S Yᵀ / Y Yᵀ) and a bfloat16 state_dtype are not
    ported yet and raise NotImplementedError."""
    if track_grams:
        raise NotImplementedError(
            "lbfgs_grams='incremental' is not ported yet")
    if state_dtype not in (None, torch.float32, "float32"):
        raise NotImplementedError(
            "lbfgs_state_dtype='bfloat16' is not ported yet")
    f, g = loss_grad(x)
    n = x.shape[0]
    return LbfgsState(
        s_hist=torch.zeros((history, n), dtype=x.dtype, device=x.device),
        y_hist=torch.zeros((history, n), dtype=x.dtype, device=x.device),
        rho=torch.zeros((history,), dtype=x.dtype, device=x.device),
        count=0, f=_f32(f.item()), g=g, n_evals=1, n_iter=0)


@contextlib.contextmanager
def _full_fp32_matmul():
    """No TF32 for the history contractions (the JAX package runs them at
    precision=HIGHEST). A process-wide switch, restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _two_loop_direction_loop(g: torch.Tensor, state: LbfgsState) -> torch.Tensor:
    """d = -H_k g via the textbook two-loop recursion (newest -> oldest,
    then oldest -> newest), on the device."""
    m = state.s_hist.shape[0]
    cnt = state.count
    k = min(cnt, m)
    q = g
    alphas = {}
    for j in range(k):
        idx = (cnt - 1 - j) % m
        a = state.rho[idx] * torch.dot(state.s_hist[idx], q)
        q = q - a * state.y_hist[idx]
        alphas[idx] = a
    if cnt > 0:
        newest = (cnt - 1) % m
        sy = torch.dot(state.s_hist[newest], state.y_hist[newest])
        yy = torch.dot(state.y_hist[newest], state.y_hist[newest])
        gamma = sy / torch.clamp(yy, min=1e-20)
    else:
        gamma = 1.0
    r = gamma * q
    for j in range(k):
        idx = (cnt - k + j) % m
        b = state.rho[idx] * torch.dot(state.y_hist[idx], r)
        r = r + state.s_hist[idx] * (alphas[idx] - b)
    return -r


def _two_loop_direction_matrix(g: torch.Tensor, state: LbfgsState) -> torch.Tensor:
    """d = -H_k g via the matrix form of the two-loop recursion.

    The same math as the loop form, reorganized as in the JAX package
    (compact representation, Byrd, Nocedal & Schnabel 1994): every
    contraction against the (m, n) history is one matmul on the device
    (S Yᵀ, Y Yᵀ, S g, Y g, then one combination), and the sequential
    alpha/beta recursions run over m-sized float32 scalars on the host."""
    m = state.s_hist.shape[0]
    S, Y = state.s_hist, state.y_hist
    cnt = state.count
    k = min(cnt, m)

    ages = np.arange(m)
    ix = (cnt - 1 - ages) % m                 # age -> buffer index
    valid = (ages < k).astype(_f32)

    with _full_fp32_matmul():
        P = (S @ Y.T).cpu().numpy()           # S Yᵀ
        Q = (Y @ Y.T).cpu().numpy()           # Y Yᵀ
        u_all = (S @ g).cpu().numpy()
        v_all = (Y @ g).cpu().numpy()
    rho_all = state.rho.cpu().numpy()
    A_sy = P[ix][:, ix]
    B_yy = Q[ix][:, ix]
    u = u_all[ix] * valid
    v = v_all[ix] * valid
    rho_t = rho_all[ix] * valid

    # alpha recursion, newest -> oldest; ages >= k carry rho_t = 0
    alpha = np.zeros((m,), _f32)
    for j in range(k):
        alpha[j] = rho_t[j] * (u[j] - np.dot(A_sy[j, :j], alpha[:j]))

    gamma = (A_sy[0, 0] / max(B_yy[0, 0], _f32(1e-20))) if cnt > 0 else _f32(1.0)

    # beta recursion, oldest -> newest, with ỹ_jᵀ q = (v - B a)_j
    yq = (v - B_yy @ alpha) * valid
    beta = np.zeros((m,), _f32)
    for j in range(k - 1, -1, -1):
        older = slice(j + 1, m)
        beta[j] = rho_t[j] * (gamma * yq[j]
                              + np.dot(A_sy[older, j],
                                       alpha[older] - beta[older]))

    coef_s = np.zeros((m,), _f32)
    coef_y = np.zeros((m,), _f32)
    coef_s[ix] = (alpha - beta) * valid
    coef_y[ix] = -gamma * alpha * valid
    cs = torch.from_numpy(coef_s).to(g.device)
    cy = torch.from_numpy(coef_y).to(g.device)
    with _full_fp32_matmul():
        r = float(gamma) * g + cs @ S + cy @ Y
    return -r


def _two_loop_direction(g: torch.Tensor, state: LbfgsState,
                        impl: str = "matrix") -> torch.Tensor:
    if impl == "loop":
        return _two_loop_direction_loop(g, state)
    if impl != "matrix":
        raise ValueError(f"unknown lbfgs direction impl {impl!r}; "
                         "expected 'matrix' or 'loop'")
    return _two_loop_direction_matrix(g, state)


def _cubic_interpolate(x1, f1, g1, x2, f2, g2, bmin, bmax):
    """Minimizer of the cubic through (x1,f1,g1)/(x2,f2,g2) clipped to
    [bmin, bmax]; bisection fallback (torch's _cubic_interpolate).
    float32 scalars in, float32 out."""
    with np.errstate(all="ignore"):
        d1 = g1 + g2 - _f32(3.0) * (f1 - f2) / (x1 - x2)
        d2_square = d1 * d1 - g1 * g2
        d2 = np.sqrt(np.maximum(d2_square, _f32(0.0)))
        if x1 <= x2:
            min_pos = x2 - (x2 - x1) * ((g2 + d2 - d1) / (g2 - g1 + _f32(2.0) * d2))
        else:
            min_pos = x1 - (x1 - x2) * ((g1 + d2 - d1) / (g1 - g2 + _f32(2.0) * d2))
        if d2_square >= 0.0 and np.isfinite(min_pos):
            return _f32(np.minimum(np.maximum(min_pos, bmin), bmax))
        return _f32(_f32(0.5) * (bmin + bmax))


def _strong_wolfe(loss_grad: LossGradFn, x: torch.Tensor, d: torch.Tensor,
                  f0: np.float32, g0: torch.Tensor, t_init: np.float32,
                  max_iter: int):
    """Strong-Wolfe line search along d from x, following torch's
    _strong_wolfe decision for decision (bracket, then zoom).

    Returns (t, f_t, g_t, n_evals). On a failed search returns the
    lowest-f bracket end, like torch."""
    gtd0 = _f32(torch.dot(g0, d).item())
    d_norm = _f32(d.abs().max().item())

    def eval_at(t):
        f, g = loss_grad(x + float(t) * d)
        return _f32(f.item()), g, _f32(torch.dot(g, d).item())

    def armijo_fail(t, f):
        return f > f0 + _f32(_C1) * t * gtd0

    def curv_ok(gtd):
        return abs(gtd) <= _f32(-_C2) * gtd0

    t = _f32(t_init)
    ls_iter = n_evals = 0
    t_prev, f_prev, gtd_prev, g_prev = _f32(0.0), f0, gtd0, g0
    bracket = False
    insuf = False
    low = 0
    b_t, b_f, b_gtd, b_g = [None, None], [None, None], [None, None], [None, None]

    while True:
        f, g, gtd = eval_at(t)
        n_evals += 1
        if not bracket:
            if ls_iter >= max_iter:
                # budget spent: lowest f of the [0, t] bracket, unchecked
                if f0 <= f:
                    return _f32(0.0), f0, g0, n_evals
                return t, f, g, n_evals
            # torch's quirk: the f_prev re-bracket check only arms from
            # the third condition evaluation (ls_iter > 1)
            fail = armijo_fail(t, f) or (ls_iter > 1 and f >= f_prev)
            if not fail and curv_ok(gtd):
                return t, f, g, n_evals
            if not fail and gtd < 0.0:
                # extrapolate within torch's [t + 0.01 (t - t_prev), 10 t]
                t_next = _cubic_interpolate(t_prev, f_prev, gtd_prev, t, f, gtd,
                                            t + _f32(0.01) * (t - t_prev),
                                            t * _f32(10.0))
                t_prev, f_prev, gtd_prev, g_prev = t, f, gtd, g
                ls_iter += 1
                insuf = False
                t = t_next
                continue
            # bracket [prev point, this trial] and start zooming
            b_t, b_f = [t_prev, t], [f_prev, f]
            b_gtd, b_g = [gtd_prev, gtd], [g_prev, g]
            low = 0 if b_f[0] <= b_f[1] else 1
            bracket = True
            insuf_prev = False
        else:
            lo, hi = low, 1 - low
            if armijo_fail(t, f) or f >= b_f[lo]:
                # the new point becomes the high end; relabel low by f
                b_t[hi], b_f[hi], b_gtd[hi], b_g[hi] = t, f, gtd, g
                low = 0 if b_f[0] <= b_f[1] else 1
                success = False
            else:
                success = curv_ok(gtd)
                if gtd * (b_t[hi] - b_t[lo]) >= 0.0:
                    b_t[hi], b_f[hi], b_gtd[hi], b_g[hi] = (
                        b_t[lo], b_f[lo], b_gtd[lo], b_g[lo])
                b_t[lo], b_f[lo], b_gtd[lo], b_g[lo] = t, f, gtd, g
            ls_iter += 1
            if success:
                return t, f, g, n_evals
            insuf_prev = insuf

        # next zoom trial, or stop on a collapsed bracket / spent budget
        if (abs(b_t[1] - b_t[0]) * d_norm < _TOL_CHANGE
                or ls_iter >= max_iter):
            return b_t[low], b_f[low], b_g[low], n_evals
        bmin, bmax = min(b_t), max(b_t)
        tz = _cubic_interpolate(b_t[0], b_f[0], b_gtd[0],
                                b_t[1], b_f[1], b_gtd[1], bmin, bmax)
        # torch's insufficient-progress guard: a trial within 10% of a
        # boundary is tolerated once, then nudged to boundary -+ eps
        eps = _f32(0.1) * (bmax - bmin)
        close = min(bmax - tz, tz - bmin) < eps
        nudge = insuf_prev or tz >= bmax or tz <= bmin
        if close and nudge:
            tz = (bmax - eps) if abs(tz - bmax) < abs(tz - bmin) else (bmin + eps)
        insuf = close and not nudge
        t = _f32(tz)


def lbfgs_step(loss_grad: LossGradFn, x: torch.Tensor, state: LbfgsState,
               lr, max_ls_steps: int = 25, direction_impl: str = "matrix",
               t_init: str = "lr") -> Tuple[torch.Tensor, LbfgsState]:
    """One L-BFGS iteration (direction + strong-Wolfe search + history
    update); updates `state` in place and returns (x_new, state).

    t_init: 'lr' — torch parity, every search opens at lr (scaled by
    min(1, 1/|g|_1) on the very first step); 'unit' — t = 1 once a
    curvature pair is stored."""
    if t_init not in ("lr", "unit"):
        raise ValueError(f"unknown lbfgs t_init {t_init!r}; "
                         "expected 'lr' or 'unit'")
    m = state.s_hist.shape[0]
    g0, f0 = state.g, state.f
    lr = _f32(lr)

    d = _two_loop_direction(g0, state, impl=direction_impl)
    dphi0 = _f32(torch.dot(g0, d).item())
    # torch breaks before the line search when the slope is not
    # meaningfully negative: the whole step is a no-op
    skip = dphi0 > -_TOL_CHANGE
    if skip:
        t, f_new, g_new, ls_evals = _f32(0.0), f0, g0, 0
    else:
        if state.n_iter == 0:
            g_l1 = _f32(g0.abs().sum().item())
            t0 = lr * min(_f32(1.0), _f32(1.0) / max(g_l1, _f32(1e-20)))
        else:
            t0 = lr
        if t_init == "unit" and state.count > 0:
            t0 = _f32(1.0)
        t, f_new, g_new, ls_evals = _strong_wolfe(
            loss_grad, x, d, f0, g0, t0, max_iter=max_ls_steps)

    s = float(t) * d
    x_new = x + s
    y = g_new - g0
    ys = _f32(torch.dot(y, s).item())
    # torch's curvature guard for the history update
    if ys > 1e-10 and not skip:
        idx = state.count % m
        state.s_hist[idx] = s
        state.y_hist[idx] = y
        state.rho[idx] = float(_f32(1.0) / max(ys, _f32(1e-20)))
        state.count += 1
    state.f, state.g = f_new, g_new
    state.n_evals += ls_evals
    state.n_iter += 1
    return x_new, state
