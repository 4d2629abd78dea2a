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

Every job runs as a lane of a (B, n) stack (``LaneLbfgsState``,
``lane_init_state``, ``lane_lbfgs_step``), as the JAX package's vmapped
while-loops run a batch: every round of the line search evaluates every
lane in one batched loss/grad call, a lane whose search has finished is
masked and keeps its state, and each lane makes its own decisions
(``_wolfe_search``, one coroutine per lane), so lane b follows its
single-job trajectory. The history contractions are batched matmuls, in
full float32 (the port never allows TF32 for matmuls; the JAX package
runs them at precision=HIGHEST), and the host reads (f, g.d) of all lanes
at once, one read per round. The
single-job forms (``LbfgsState``, ``init_state``, ``lbfgs_step``) are the
B = 1 view of the lane forms. The lane forms also take a space row's
lanes (parallel/space.py ``SpaceLanes``): x, g, d and the s/y history
are then row blocks on the row's devices, elementwise work runs per
block, and every contraction over the pixels (``_dot``, ``_rows_dot``,
``_hist_gram``) is per-block partials summed on the first device, where
rho, the carried Grams and the scalars the host reads stay.

Two state options of the JAX package (its TPU production settings):
- carried Grams (``track_grams``, config ``lbfgs_grams='incremental'``):
  S Yᵀ and Y Yᵀ live in the state and each stored pair refreshes one row
  and column of them (``_update_grams``) instead of the matrix direction
  recomputing both from the (m, n) buffers every step;
- bfloat16 history (``state_dtype='bfloat16'``): the s/y pairs are
  quantised once when stored; rho, the Grams, g and the direction stay
  float32, and every contraction against the buffers accumulates in
  float32 and returns float32 (``_bmm_f32``), as the JAX package's
  ``preferred_element_type=float32`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils.metrics import span

# Wolfe constants and tolerances (torch's values).
_C1 = 1e-4
_C2 = 0.9
_TOL_CHANGE = 1e-9

_f32 = np.float32

# loss_grad(x) -> ((B,) losses, (B, n) gradients) of the (B, n) lanes x.
# The results must be tensors the caller owns (a gradient is kept across
# later evaluations: state.g, the line search's bracket ends); a graphed
# evaluation copies its outputs out for that (engine/graphs.py). It may
# also have along(x, t, d), the same at x + t d, which a graphed
# evaluation writes straight into its static input.
LossGradFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def _read(t: torch.Tensor) -> np.ndarray:
    """t on the host: one blocking device->host read (an lbfgs.read
    span; ended by hand, not entered: nothing runs inside it, and the
    innermost-span variable is the larger part of a span's cost)."""
    read = span("lbfgs.read")
    host = t.cpu().numpy()
    read.end()
    return host


def _eval_along(loss_grad: LossGradFn, x: torch.Tensor, t: torch.Tensor,
                d: torch.Tensor):
    """loss_grad at the trial points x + t d (t (B, 1)), formed by one
    addcmul whichever way loss_grad evaluates, so the graphed and the
    eager trajectories see the same points."""
    along = getattr(loss_grad, "along", None)
    if along is not None:
        return along(x, t, d)
    return loss_grad(x.addcmul(t, d))


@dataclasses.dataclass
class LbfgsState:
    """One job's state: lane 0 of a LaneLbfgsState, with plain scalars."""

    s_hist: torch.Tensor  # (m, n) parameter-difference history
    y_hist: torch.Tensor  # (m, n) gradient-difference history
    rho: torch.Tensor     # (m,)   1 / (y . s)
    count: int            # number of pairs ever stored
    f: np.float32         # loss at the current point
    g: torch.Tensor       # (n,)   gradient at the current point
    n_evals: int          # cumulative loss/grad evaluations
    n_iter: int           # completed lbfgs_step calls (torch n_iter)
    sy_gram: Optional[torch.Tensor] = None  # (m, m) carried S Yᵀ, or None
    yy_gram: Optional[torch.Tensor] = None  # (m, m) carried Y Yᵀ, or None


def history_dtype(state_dtype) -> torch.dtype:
    """The storage dtype of the s/y history buffers: float32 (None, the
    default) or bfloat16."""
    if state_dtype in (None, "float32", torch.float32):
        return torch.float32
    if state_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unknown lbfgs state dtype {state_dtype!r}; "
                     "expected 'float32' or 'bfloat16'")


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-lane a @ b, accumulated in float32 and returned in float32
    (the JAX package's preferred_element_type=float32). float32 operands
    take a plain bmm; bfloat16 ones (the history buffers and the operands
    quantised against them) take bmm's float32 output dtype on the card,
    which reads the buffers as they are stored, and on the CPU are
    promoted to float32 first (the product of two bfloat16 values is exact
    in float32)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    if a.device.type != "cpu":
        raise RuntimeError(f"no bfloat16 contraction on {a.device}")
    return torch.bmm(a.float(), b.float())


def _dot(a, b):
    """a . b of two (n,) rows: a plain tensor's torch.dot, or a space
    row's per-block partials summed (parallel/space.py SpaceLanes)."""
    return torch.dot(a, b) if isinstance(a, torch.Tensor) else a.dot(b)


def _rows_dot(hist, v):
    """(B, k): each of the k rows of a (B, k, n) history dotted with the
    lane's (B, n) vector v, accumulated in float32."""
    if isinstance(hist, torch.Tensor):
        return _bmm_f32(hist, v.unsqueeze(2)).squeeze(2)
    return hist.rows_dot(v, _bmm_f32)


def _hist_gram(a, b):
    """(B, k, k) = A Bᵀ of two (B, k, n) histories, in float32."""
    if isinstance(a, torch.Tensor):
        return _bmm_f32(a, b.transpose(1, 2))
    return a.gram(b, _bmm_f32)


def _combine(coef: torch.Tensor, hist):
    """(B, n) = coef (B, k) times a (B, k, n) history, in float32."""
    if isinstance(hist, torch.Tensor):
        return _bmm_f32(coef.unsqueeze(1), hist).squeeze(1)
    return hist.combine(coef, _bmm_f32)


def _stack_rows(rows):
    """torch.stack of (n,) rows, whichever layout they have."""
    if isinstance(rows[0], torch.Tensor):
        return torch.stack(rows)
    return type(rows[0]).stack(rows)


def _like(leaf, x):
    """A leaf of x's pixel layout placed as x is: on x's device, or cut
    into the blocks of a space row (a leaf already so placed stays)."""
    if isinstance(x, torch.Tensor):
        return leaf.to(x.device)
    return x.place(leaf)


def _two_loop_direction_loop(g: torch.Tensor, state: LbfgsState) -> torch.Tensor:
    """d = -H_k g via the textbook two-loop recursion (newest -> oldest,
    then oldest -> newest), on the device. bfloat16 rows are promoted
    against the float32 g and q (g itself is not quantised), as in the
    JAX package's loop form."""
    m = state.s_hist.shape[0]
    cnt = state.count
    k = min(cnt, m)

    def s_row(i):
        return state.s_hist[i].float()

    def y_row(i):
        return state.y_hist[i].float()

    q = g
    alphas = {}
    for j in range(k):
        idx = (cnt - 1 - j) % m
        a = state.rho[idx] * _dot(s_row(idx), q)
        q = q - a * y_row(idx)
        alphas[idx] = a
    if cnt > 0:
        newest = (cnt - 1) % m
        sy = _dot(s_row(newest), y_row(newest))
        yy = _dot(y_row(newest), y_row(newest))
        gamma = sy / torch.clamp(yy, min=1e-20)
    else:
        gamma = 1.0
    r = gamma * q
    for j in range(k):
        idx = (cnt - k + j) % m
        b = state.rho[idx] * _dot(y_row(idx), r)
        r = r + s_row(idx) * (alphas[idx] - b)
    return -r


def _two_loop_coefficients(P: np.ndarray, Q: np.ndarray, u_all: np.ndarray,
                           v_all: np.ndarray, rho_all: np.ndarray, cnt: int):
    """The host side of the matrix form of the two-loop recursion
    (compact representation, Byrd, Nocedal & Schnabel 1994, as in the JAX
    package) for one history of m buffer rows:
    from S Yᵀ (P), Y Yᵀ (Q), S g, Y g, rho and the pair count, the
    (gamma, coef_s, coef_y) of -d = gamma g + coef_sᵀ S + coef_yᵀ Y."""
    m = P.shape[0]
    k = min(cnt, m)
    ages = np.arange(m)
    ix = (cnt - 1 - ages) % m                 # age -> buffer index
    valid = (ages < k).astype(_f32)
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
    return gamma, coef_s, coef_y


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


def _wolfe_search(f0: np.float32, g0, gtd0: np.float32, d_norm: np.float32,
                  t_init: np.float32, max_iter: int):
    """The decisions of one strong-Wolfe search, as a coroutine: it yields
    each trial step t and is sent back (f, g, g.d) at x + t d; it returns
    (t, f_t, g_t, n_evals). g is only carried, never read, so it may be a
    row of a batched gradient."""

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
        f, g, gtd = yield t
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


# --------------------------------------------------------------------------
# Lanes: B independent jobs in lockstep
# --------------------------------------------------------------------------


@dataclasses.dataclass
class LaneLbfgsState:
    """LbfgsState with a leading lane axis; the host scalars become (B,)
    numpy arrays. n_iter is an int while the lanes step together; a live
    batch (parallel/live.py), whose lanes joined at different steps,
    carries a (B,) array."""

    s_hist: torch.Tensor  # (B, m, n) float32 or bfloat16
    y_hist: torch.Tensor  # (B, m, n) float32 or bfloat16
    rho: torch.Tensor     # (B, m)
    count: np.ndarray     # (B,) int64
    f: np.ndarray         # (B,) float32
    g: torch.Tensor       # (B, n)
    n_evals: np.ndarray   # (B,) int64
    n_iter: Union[int, np.ndarray]
    sy_gram: Optional[torch.Tensor] = None  # (B, m, m) carried S Yᵀ
    yy_gram: Optional[torch.Tensor] = None  # (B, m, m) carried Y Yᵀ

    def select(self, lanes: Sequence[int]) -> None:
        """Keep (and repeat) the given lanes, in that order, in place."""
        idx = torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                              device=self.g.device)
        self.s_hist = self.s_hist.index_select(0, idx)
        self.y_hist = self.y_hist.index_select(0, idx)
        self.rho = self.rho.index_select(0, idx)
        self.g = self.g.index_select(0, idx)
        if self.sy_gram is not None:
            self.sy_gram = self.sy_gram.index_select(0, idx)
            self.yy_gram = self.yy_gram.index_select(0, idx)
        self.count = self.count[lanes]
        self.f = self.f[lanes]
        self.n_evals = self.n_evals[lanes]
        if isinstance(self.n_iter, np.ndarray):
            self.n_iter = self.n_iter[lanes]


def lane_init_state(loss_grad: LossGradFn, x: torch.Tensor, history: int,
                    track_grams: bool = False,
                    state_dtype=None) -> LaneLbfgsState:
    """Initial state of the (B, n) lanes x; one batched evaluation.
    loss_grad maps (B, n) to ((B,) losses, (B, n) gradients).

    track_grams: carry the (B, m, m) S Yᵀ / Y Yᵀ Grams, zeros until rows
    are stored (the JAX package's init_state). state_dtype: storage dtype
    of the (B, m, n) s/y buffers, float32 (None) or 'bfloat16'; rho and
    the Grams stay float32."""
    hdt = history_dtype(state_dtype)
    f, g = loss_grad(x)
    b, n = x.shape
    grams = (torch.zeros((b, history, history), dtype=x.dtype,
                         device=x.device) if track_grams else None)

    def hist():
        if isinstance(x, torch.Tensor):
            return torch.zeros((b, history, n), dtype=hdt, device=x.device)
        return type(x)([torch.zeros((b, history, blk.shape[-1]), dtype=hdt,
                                    device=blk.device) for blk in x.blocks])

    return LaneLbfgsState(
        s_hist=hist(), y_hist=hist(),
        rho=torch.zeros((b, history), dtype=x.dtype, device=x.device),
        count=np.zeros((b,), np.int64), f=f.cpu().numpy().astype(_f32),
        g=g, n_evals=np.ones((b,), np.int64), n_iter=0,
        sy_gram=grams, yy_gram=None if grams is None else grams.clone())


def lane_state_specs(b: int, n: int, history: int, track_grams: bool,
                     state_dtype=None) -> Dict[str, torch.Tensor]:
    """{leaf name: a meta tensor of its shape and dtype} of a lane state,
    the template a checkpoint of one is loaded against."""
    hdt = history_dtype(state_dtype)

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    specs = {"s_hist": meta((b, history, n), hdt),
             "y_hist": meta((b, history, n), hdt),
             "rho": meta((b, history))}
    if track_grams:
        specs["sy_gram"] = meta((b, history, history))
        specs["yy_gram"] = meta((b, history, history))
    specs.update(g=meta((b, n)), count=meta((b,), torch.int64),
                 f=meta((b,)), n_evals=meta((b,), torch.int64),
                 n_iter=meta((), torch.int64))
    return specs


def state_leaves(state: LaneLbfgsState) -> Dict[str, torch.Tensor]:
    """The named leaves of a lane state (lane_state_specs's names; a live
    batch's per-lane n_iter is a (B,) leaf, which no checkpoint takes)."""
    leaves = {"s_hist": state.s_hist, "y_hist": state.y_hist,
              "rho": state.rho}
    if state.sy_gram is not None:
        leaves.update(sy_gram=state.sy_gram, yy_gram=state.yy_gram)
    leaves.update(g=state.g, count=torch.from_numpy(state.count.copy()),
                  f=torch.from_numpy(state.f.copy()),
                  n_evals=torch.from_numpy(state.n_evals.copy()),
                  n_iter=torch.tensor(state.n_iter, dtype=torch.int64))
    return leaves


def state_from_leaves(leaves: Dict[str, torch.Tensor],
                      x) -> LaneLbfgsState:
    """The lane state that state_leaves gave, placed as the (B, n) lanes
    x are: on x's device, or, for a space row's x, the pixel-axis leaves
    (s_hist, y_hist, g) cut into its blocks and the rest on its first
    device."""
    def dev(name):
        if name not in leaves:
            return None
        if name in ("s_hist", "y_hist", "g"):
            return _like(leaves[name], x)
        return leaves[name].to(x.device)

    return LaneLbfgsState(
        s_hist=dev("s_hist"), y_hist=dev("y_hist"), rho=dev("rho"),
        count=leaves["count"].numpy().astype(np.int64),
        f=leaves["f"].numpy().astype(_f32), g=dev("g"),
        n_evals=leaves["n_evals"].numpy().astype(np.int64),
        n_iter=(int(leaves["n_iter"]) if leaves["n_iter"].dim() == 0
                else leaves["n_iter"].numpy().astype(np.int64)),
        sy_gram=dev("sy_gram"),
        yy_gram=dev("yy_gram"))


def _lane_view(state: LaneLbfgsState, b: int) -> LbfgsState:
    return LbfgsState(state.s_hist[b], state.y_hist[b], state.rho[b],
                      int(state.count[b]), state.f[b], state.g[b],
                      int(state.n_evals[b]),
                      int(np.broadcast_to(state.n_iter, state.count.shape)[b]),
                      None if state.sy_gram is None else state.sy_gram[b],
                      None if state.yy_gram is None else state.yy_gram[b])


def _lane_two_loop_direction(g: torch.Tensor, state: LaneLbfgsState,
                             impl: str = "matrix") -> torch.Tensor:
    """(B, n) directions. 'matrix': the history contractions of every lane
    as batched matmuls over the buffer rows any lane has filled (S Yᵀ and
    Y Yᵀ read from the state when it carries them), one device->host
    read, then each lane's host recursion (_two_loop_coefficients).
    With bfloat16 buffers g is quantised to bfloat16 before S g and Y g,
    and the coefficients before the final combination, as in the JAX
    package's matrix form. 'loop': the textbook loop form per lane."""
    if impl == "loop":
        return _stack_rows([_two_loop_direction_loop(g[b],
                                                     _lane_view(state, b))
                            for b in range(g.shape[0])])
    if impl != "matrix":
        raise ValueError(f"unknown lbfgs direction impl {impl!r}; "
                         "expected 'matrix' or 'loop'")
    nb, m, _ = state.s_hist.shape
    k = int(min(state.count.max(), m))
    if k == 0:
        return -g
    S, Y = state.s_hist[:, :k], state.y_hist[:, :k]
    if state.sy_gram is not None:
        P, Q = state.sy_gram[:, :k, :k], state.yy_gram[:, :k, :k]
    else:
        P = _hist_gram(S, Y)                                   # S Yᵀ
        Q = _hist_gram(Y, Y)                                   # Y Yᵀ
    g_h = g.to(S.dtype)
    host = _read(torch.cat([
        P.reshape(nb, k * k), Q.reshape(nb, k * k),
        _rows_dot(S, g_h),                                     # S g
        _rows_dot(Y, g_h),                                     # Y g
    ], dim=1))
    rho = _read(state.rho)
    P = np.zeros((m, m), _f32)
    Q = np.zeros((m, m), _f32)
    u = np.zeros((m,), _f32)
    v = np.zeros((m,), _f32)
    gamma = np.zeros((nb,), _f32)
    coef_s = np.zeros((nb, k), _f32)
    coef_y = np.zeros((nb, k), _f32)
    for b in range(nb):
        P[:k, :k] = host[b, :k * k].reshape(k, k)
        Q[:k, :k] = host[b, k * k:2 * k * k].reshape(k, k)
        u[:k] = host[b, 2 * k * k:2 * k * k + k]
        v[:k] = host[b, 2 * k * k + k:]
        gamma[b], cs, cy = _two_loop_coefficients(P, Q, u, v, rho[b],
                                                  int(state.count[b]))
        coef_s[b], coef_y[b] = cs[:k], cy[:k]  # rows >= k are never valid
    dev, hdt = g.device, S.dtype
    r = (torch.from_numpy(gamma).to(dev).unsqueeze(1) * g
         + _combine(torch.from_numpy(coef_s).to(dev, hdt), S)
         + _combine(torch.from_numpy(coef_y).to(dev, hdt), Y))
    return -r


def _lane_strong_wolfe(loss_grad: LossGradFn, x: torch.Tensor,
                       d: torch.Tensor, f0: np.ndarray, g0: torch.Tensor,
                       gtd0: np.ndarray, t_init: np.ndarray, max_iter: int,
                       lanes: Sequence[int]) -> Dict[int, tuple]:
    """The strong-Wolfe searches of `lanes` in lockstep: each round
    evaluates every lane at once (lanes not searching sit at t = 0, their
    values unread) and sends each searching lane its own (f, g, g.d).
    Returns {lane: (t, f_t, g_t, n_evals)}."""
    d_norm = _read(d.abs().amax(dim=1))
    t_now = np.zeros((x.shape[0],), _f32)
    searches = {}
    for b in lanes:
        searches[b] = _wolfe_search(f0[b], g0[b], gtd0[b], d_norm[b],
                                    t_init[b], max_iter)
        t_now[b] = next(searches[b])
    results = {}
    while searches:
        t_dev = torch.from_numpy(t_now.copy()).to(x.device).unsqueeze(1)
        f, g = _eval_along(loss_grad, x, t_dev, d)
        fg = _read(torch.stack([f.float(), (g * d).sum(dim=1)]))
        for b in list(searches):
            try:
                t_now[b] = searches[b].send((_f32(fg[0, b]), g[b],
                                             _f32(fg[1, b])))
            except StopIteration as done:
                results[b] = done.value
                del searches[b]
                t_now[b] = 0.0
    return results


def lane_lbfgs_step(loss_grad: LossGradFn, x: torch.Tensor,
                    state: LaneLbfgsState, lr: np.ndarray,
                    max_ls_steps: int = 25, direction_impl: str = "matrix",
                    t_init: str = "lr") -> Tuple[torch.Tensor, LaneLbfgsState]:
    """One L-BFGS iteration (direction + strong-Wolfe search + history
    update) for every lane of x (B, n) at once, lr a (B,) float32 array;
    updates `state` in place and returns (x_new, state). Each lane makes
    its own decisions on its own values.

    t_init: 'lr' — torch parity, every search opens at lr (scaled by
    min(1, 1/|g|_1) on the very first step); 'unit' — t = 1 once a
    curvature pair is stored."""
    if t_init not in ("lr", "unit"):
        raise ValueError(f"unknown lbfgs t_init {t_init!r}; "
                         "expected 'lr' or 'unit'")
    with span("lbfgs.step", lanes=state.rho.shape[0], path="host") as step:
        nb, m = state.rho.shape
        g0, f0 = state.g, state.f
        lr = np.asarray(lr, _f32)

        with span("lbfgs.direction", lanes=nb, n=g0.shape[1],
                  pairs=int(np.minimum(state.count, m).sum())):
            d = _lane_two_loop_direction(g0, state, impl=direction_impl)
        dphi0, g_l1 = _read(torch.stack([(g0 * d).sum(dim=1),
                                         g0.abs().sum(dim=1)]))
        dphi0 = dphi0.astype(_f32)
        # torch breaks before the line search when the slope is not
        # meaningfully negative: that lane's step is a no-op
        skip = dphi0 > -_TOL_CHANGE
        t0 = np.empty((nb,), _f32)
        first = np.broadcast_to(np.asarray(state.n_iter) == 0, (nb,))
        for b in range(nb):
            if first[b]:
                t0[b] = lr[b] * min(_f32(1.0), _f32(1.0)
                                    / max(_f32(g_l1[b]), _f32(1e-20)))
            else:
                t0[b] = lr[b]
            if t_init == "unit" and state.count[b] > 0:
                t0[b] = _f32(1.0)
        with span("lbfgs.search") as search:
            found = _lane_strong_wolfe(loss_grad, x, d, f0, g0, dphi0, t0,
                                       max_ls_steps,
                                       np.flatnonzero(~skip).tolist())
            t = np.zeros((nb,), _f32)
            f_new = f0.copy()
            g_rows = [g0[b] for b in range(nb)]
            ls_evals = np.zeros((nb,), np.int64)
            for b, (tb, fb, gb, nb_evals) in found.items():
                t[b], f_new[b], g_rows[b], ls_evals[b] = tb, fb, gb, nb_evals
            # a round evaluates every lane still searching, once
            rounds = int(ls_evals.max())
            search.set(rounds=rounds, evals=int(ls_evals.sum()))
        g_new = _stack_rows(g_rows)
        s = torch.from_numpy(t).to(x.device).unsqueeze(1) * d
        x_new = x + s
        y = g_new - g0
        ys_dev = (y * s).sum(dim=1)
        ys = _read(ys_dev)
        # torch's curvature guard for the history update
        store = np.flatnonzero((ys > 1e-10) & ~skip)
        if store.size:
            _store_pairs(state, store, s, y, ys, ys_dev)
        state.f, state.g = f_new, g_new
        state.n_evals += ls_evals
        state.n_iter += 1
        step.set(evals=rounds)
        return x_new, state


def _store_pairs(state: LaneLbfgsState, lanes: np.ndarray, s: torch.Tensor,
                 y: torch.Tensor, ys: np.ndarray,
                 ys_dev: torch.Tensor) -> None:
    """Write each storing lane's pair into row count % m of its buffers
    (quantised once, to the buffers' dtype), its rho, and, when the state
    carries them, refresh that row and column of its Grams. One launch per
    write for all the storing lanes together."""
    m = state.rho.shape[1]
    dev = s.device
    idx_np = state.count[lanes] % m
    lane_t = torch.from_numpy(lanes).to(dev)
    idx_t = torch.from_numpy(idx_np).to(dev)
    s_q = s.to(state.s_hist.dtype)
    y_q = y.to(state.y_hist.dtype)
    state.s_hist[lane_t, idx_t] = s_q.index_select(0, lane_t)
    state.y_hist[lane_t, idx_t] = y_q.index_select(0, lane_t)
    rho = (_f32(1.0) / np.maximum(ys[lanes].astype(_f32), _f32(1e-20)))
    state.rho[lane_t, idx_t] = torch.from_numpy(rho.astype(_f32)).to(dev)
    state.count[lanes] += 1
    if state.sy_gram is not None:
        k = int(min(state.count.max(), m))
        _update_grams(state, lane_t, idx_t, s_q, y_q, ys_dev, k)


def _update_grams(state: LaneLbfgsState, lane_t: torch.Tensor,
                  idx_t: torch.Tensor, s_q: torch.Tensor, y_q: torch.Tensor,
                  ys_dev: torch.Tensor, k: int) -> None:
    """The JAX package's _update_grams for the storing lanes: after their
    pairs went into rows idx of the buffers, row idx of P = S Yᵀ becomes
    s_q · Y, column idx becomes S · y_q, row and column idx of Q = Y Yᵀ
    become y_q · Y, and P[idx, idx] the step's own y·s (the float32 value
    rho reads). Entries are replaced, never accumulated, so every entry
    stays a dot of the current buffer rows; s_q and y_q are the pairs as
    stored (bfloat16 when the buffers are). The products run over every
    lane at once (three GEMVs over the k rows any lane has filled; rows
    beyond them are zero) and only the storing lanes' rows and columns are
    written."""
    S, Y = state.s_hist[:, :k], state.y_hist[:, :k]
    p_row = _rows_dot(Y, s_q)[lane_t]                          # y_j · s_q
    q_row = _rows_dot(Y, y_q)[lane_t]                          # y_j · y_q
    p_col = _rows_dot(S, y_q)[lane_t]                          # s_j · y_q
    P, Q = state.sy_gram, state.yy_gram
    P[lane_t, idx_t, :k] = p_row
    P[lane_t, :k, idx_t] = p_col
    P[lane_t, idx_t, idx_t] = ys_dev[lane_t]
    Q[lane_t, idx_t, :k] = q_row
    Q[lane_t, :k, idx_t] = q_row


# --------------------------------------------------------------------------
# One job: the B = 1 view of the lane forms
# --------------------------------------------------------------------------


def _one_lane(loss_grad: LossGradFn) -> LossGradFn:
    """Lift a single-job loss_grad ((n,) -> (0-d, (n,))) to one lane."""

    def lanes(x):
        f, g = loss_grad(x[0])
        return f.reshape(1), g.unsqueeze(0)

    return lanes


def _as_lanes(state: LbfgsState) -> LaneLbfgsState:
    """A one-lane state whose tensors are views of `state`'s."""
    grams = [None if t is None else t.unsqueeze(0)
             for t in (state.sy_gram, state.yy_gram)]
    return LaneLbfgsState(
        state.s_hist.unsqueeze(0), state.y_hist.unsqueeze(0),
        state.rho.unsqueeze(0), np.array([state.count], np.int64),
        np.array([state.f], _f32), state.g.unsqueeze(0),
        np.array([state.n_evals], np.int64), state.n_iter, *grams)


def init_state(loss_grad: LossGradFn, x: torch.Tensor, history: int,
               track_grams: bool = False, state_dtype=None) -> LbfgsState:
    """lane_init_state for one job."""
    return _lane_view(lane_init_state(_one_lane(loss_grad), x.unsqueeze(0),
                                      history, track_grams, state_dtype), 0)


def _two_loop_direction(g: torch.Tensor, state: LbfgsState,
                        impl: str = "matrix") -> torch.Tensor:
    """d = -H_k g for one job ('matrix' or 'loop' form)."""
    return _lane_two_loop_direction(g.unsqueeze(0), _as_lanes(state), impl)[0]


def _strong_wolfe(loss_grad: LossGradFn, x: torch.Tensor, d: torch.Tensor,
                  f0: np.float32, g0: torch.Tensor, t_init: np.float32,
                  max_iter: int):
    """One job's strong-Wolfe search along d from x, following torch's
    _strong_wolfe decision for decision (bracket, then zoom). Returns
    (t, f_t, g_t, n_evals); on a failed search the lowest-f bracket end,
    like torch."""
    found = _lane_strong_wolfe(
        _one_lane(loss_grad), x.unsqueeze(0), d.unsqueeze(0),
        np.array([f0], _f32), g0.unsqueeze(0),
        np.array([torch.dot(g0, d).item()], _f32),
        np.array([t_init], _f32), max_iter, [0])
    return found[0]


def lbfgs_step(loss_grad: LossGradFn, x: torch.Tensor, state: LbfgsState,
               lr, max_ls_steps: int = 25, direction_impl: str = "matrix",
               t_init: str = "lr") -> Tuple[torch.Tensor, LbfgsState]:
    """lane_lbfgs_step for one job; updates `state` in place and returns
    (x_new, state)."""
    lanes = _as_lanes(state)  # the history rows are written through
    x_new, lanes = lane_lbfgs_step(_one_lane(loss_grad), x.unsqueeze(0),
                                   lanes, np.array([lr], _f32), max_ls_steps,
                                   direction_impl, t_init)
    one = _lane_view(lanes, 0)
    state.count, state.f, state.g = one.count, one.f, one.g
    state.n_evals, state.n_iter = one.n_evals, one.n_iter
    return x_new[0], state
