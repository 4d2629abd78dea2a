"""The L-BFGS step on the card: the vector work between two line-search
reads as captured graphs, the host waiting once a round.

engine/lbfgs.py's host-driven step (``lane_lbfgs_step``) reads the device
six ways a step (the direction's Grams and products, rho, g·d and |g|₁,
max |d|, each round's (f, g·d), y·s), and after each read the stream is
empty while the host issues the next run of small launches. Here only the
strong-Wolfe decisions stay on the host (``lbfgs._wolfe_search``, the same
coroutine per lane), and the host reads once a line-search round. A step
launches, on one stream and with no read between them:

(a) ``accept`` (one graph): the previous step's x + t d, y = g_t - g and
    y·s; the curvature guard y·s > 1e-10 as a mask, under which the pair,
    rho, the pair count and the carried Grams' row and column are written
    at ring row count % m by device-side index; then this step's
    direction: S g, Y g, the two-loop coefficients (kernels/lbfgs.py), d,
    g·d, max |d| and the first trial step t0, and the first trial point
    x + t0 d written into the evaluation's static input;
(b) the captured evaluation (engine/graphs.py ``EvalGraph``, through
    ``LossGrad.replay``);
(c) ``tail`` (one graph): g·d at the trial point, the trial's gradient and
    loss into a slot the host names, and the round's scalars into a pinned
    host buffer; then an event.

The launch of (a), the only graph that reads or writes history rows, is an
``lbfgs.history`` span (lanes, n: the row length, and pairs: the pairs
the lanes hold once (a) has stored, summed over the lanes, which the card
writes into the round's scalars and the host sets at its next read).

The host waits for the event, reads the pinned buffer and sends each
searching lane's (f, slot, g·d) to its coroutine. A later round writes
its trial step into a pinned buffer that its first graph (``trial``:
x + t d into the static input) reads, then runs (b) and (c). When every
search has ended, the host launches (a) for the accepted slots, which
also opens the next step with its first evaluation; a lane whose next
step turns out to be torch's no-op (g·d > -1e-9) throws that evaluation
away, and a next step called with another lr or another x than the one
foreseen launches (a) again without an accept. The pinned buffers move
through copies captured in the graphs (memcpy nodes): each replay reads
what the host wrote before its launch.

The line search's bracket ends are slots: the gradients stay on the card
(``slots``: a lane's point's gradient in slot 0, its trials in the rest),
and a lane's coroutine holds a ``_Slot`` where it would hold a gradient;
a trial slot is free again once nothing holds its ``_Slot``.

Which jobs take it: ``engages`` reads the form from the input (x a plain
CUDA tensor, a graphed evaluation, the matrix direction with carried
Grams: the production L-BFGS job on CUDA). Every other form (the CPU,
graphs=False, a space row's SpaceLanes, the loop direction, no carried
Grams) takes ``lane_lbfgs_step``. Both make the same decisions on float32
values; the coefficients sum in another order, and the card's history
products run over all m rows, the rows not yet stored being zeros.
The pair counts live on the card; the host's copy in the state is
brought up to date by ``settle`` (a checkpoint, a lane selection).
"""

from __future__ import annotations

import weakref
from typing import Callable, Dict

import numpy as np
import torch

from .. import kernels
from ..kernels import lbfgs as klbfgs
from ..utils.metrics import span
from . import graphs as graphs_mod
from .lbfgs import (_TOL_CHANGE, LaneLbfgsState, _combine, _f32, _rows_dot,
                    _wolfe_search)

# A lane's gradient slots: its point's (0) and four trials, as many as a
# search can hold (its previous point or two bracket ends, and the point
# it bracketed from) and the one being written.
SLOTS = 5

# rows of the pinned input: a round's trial step and the slot its gradient
# goes to; the accepted step and slot, the next step's lr and its
# first-step flag (torch scales a job's first step by 1 / |g|₁)
_T, _W, _T_ACC, _ACC, _LR, _FIRST = range(6)
# rows of the pinned output: the trial's f and g·d; the step's g·d at x,
# max |d| and t0; the pairs each lane holds after the last accept
_F, _GTD, _GTD0, _DMAX, _T0, _PAIRS = range(6)


class _Slot:
    """A gradient slot that a lane's search holds (an index into
    CardSteps.slots)."""

    __slots__ = ("index", "__weakref__")

    def __init__(self, index: int):
        self.index = index


def _card_device(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def engages(loss_grad, x, state: LaneLbfgsState, direction_impl: str) -> bool:
    """Whether the (B, n) lanes x step on the card: x a plain CUDA tensor,
    a graphed evaluation, the matrix direction and carried Grams."""
    return (_card_device(x) and loss_grad.graphed
            and direction_impl == "matrix" and state.sy_gram is not None)


class CardSteps:
    """The L-BFGS steps of a lane state on the card.

    loss_grad: a graphed LossGrad (graphed, graph(x), replay()); x: the
    (B, n) lanes, which this object steps in place from now on; state: the
    lanes' state, whose history, rho and Grams the graphs update in place
    (state.g becomes slot 0). The graphs bind the lanes' buffers, so they
    are captured here, once for the lanes (engine/transfer.py's _Lbfgs
    makes this at their first step): on the card by graphs.cuda_capture,
    on the CPU by the eager test seam."""

    def __init__(self, loss_grad, x: torch.Tensor, state: LaneLbfgsState,
                 max_ls_steps: int = 25, t_init: str = "lr"):
        if t_init not in ("lr", "unit"):
            raise ValueError(f"unknown lbfgs t_init {t_init!r}; "
                             "expected 'lr' or 'unit'")
        nb, n = x.shape
        dev = x.device
        cuda = dev.type == "cuda"
        self.loss_grad, self.state = loss_grad, state
        self.max_ls, self.unit = max_ls_steps, t_init == "unit"
        self.entry = loss_grad.graph(x)
        self.x = x
        self.d = torch.zeros_like(x)
        self.slots = torch.empty((SLOTS, nb, n), dtype=x.dtype, device=dev)
        self.slots[0].copy_(state.g)
        state.g = self.slots[0]
        self.fslots = torch.zeros((SLOTS, nb), dtype=torch.float32,
                                  device=dev)
        self.fslots[0].copy_(torch.from_numpy(np.asarray(state.f, _f32)))
        self.count = torch.from_numpy(state.count.copy()).to(dev)
        self._lanes = torch.arange(nb, device=dev)
        self._par = torch.zeros((6, nb), dtype=torch.float32, device=dev)
        self._out = torch.zeros((6, nb), dtype=torch.float32, device=dev)
        self._host_in = torch.zeros((6, nb), dtype=torch.float32,
                                    pin_memory=cuda)
        self._host_out = torch.zeros((6, nb), dtype=torch.float32,
                                     pin_memory=cuda)
        self._in, self._out_np = self._host_in.numpy(), self._host_out.numpy()
        self._event = torch.cuda.Event() if cuda else None
        self._index = dev.index
        self._held = []
        self._pending = None  # (lr, first) of the step (a) opened last
        self._history = None  # the lbfgs.history span awaiting its pairs
        capture = graphs_mod.cuda_capture if cuda else graphs_mod.eager_capture
        # the captures' eager passes accept nothing: t = 0 from slot 0
        self._in[:] = 0.0
        self._in[_W], self._in[_LR] = 1.0, 1.0
        self._graphs: Dict[str, tuple] = {}
        with self.entry.lock:
            for name, body in (("accept", self._accept_body),
                               ("trial", self._trial_body),
                               ("tail", self._tail_body)):
                replay, _out, launches = capture(body, dev)
                self._graphs[name] = (replay, launches)

    # ---- the captured work -------------------------------------------------

    def _accept_body(self):
        self._par.copy_(self._host_in, non_blocking=True)
        st, par = self.state, self._par
        nb, n = self.x.shape
        s = par[_T_ACC].unsqueeze(1) * self.d
        self.x.add_(s)
        rows = par[_ACC].long() * nb + self._lanes
        g0 = self.slots[0]
        g_new = self.slots.view(-1, n).index_select(0, rows)
        y = g_new - g0
        ys = (y * s).sum(dim=1)
        self._store(st, s, y, ys)
        self._out[_PAIRS].copy_(torch.clamp(self.count, max=st.rho.shape[1]))
        g0.copy_(g_new)
        self.fslots[0].copy_(self.fslots.view(-1).index_select(0, rows))
        self._direction(st, par[_LR], par[_FIRST] > 0)
        return ()

    def _store(self, st: LaneLbfgsState, s, y, ys) -> None:
        """lbfgs._store_pairs under the curvature guard as a mask: each
        lane's pair, rho and Gram row and column at ring row count % m,
        kept where y·s > 1e-10, else the old values written back."""
        nb, m = st.rho.shape
        keep = ys > 1e-10
        idx = self.count % m
        rows = self._lanes * m + idx
        s_q, y_q = s.to(st.s_hist.dtype), y.to(st.y_hist.dtype)
        for hist, new in ((st.s_hist, s_q), (st.y_hist, y_q)):
            flat = hist.view(nb * m, -1)
            flat.index_copy_(0, rows, torch.where(
                keep.unsqueeze(1), new, flat.index_select(0, rows)))
        rho = st.rho.view(-1)
        rho.index_copy_(0, rows, torch.where(
            keep, torch.reciprocal(torch.clamp(ys, min=1e-20)),
            rho.index_select(0, rows)))
        self.count.add_(keep.long())
        # lbfgs._update_grams over every row (rows not yet stored are
        # zeros): row idx of P = S Yᵀ is s_q · Y, column idx S · y_q, and
        # P[idx, idx] the step's y·s; row and column idx of Q are y_q · Y
        p_row = _rows_dot(st.y_hist, s_q)
        q_row = _rows_dot(st.y_hist, y_q)
        p_col = _rows_dot(st.s_hist, y_q)
        at = keep.unsqueeze(1) & (torch.arange(m, device=idx.device)
                                  == idx.unsqueeze(1))          # (B, m)
        row, col = at.unsqueeze(2), at.unsqueeze(1)
        P, Q = st.sy_gram, st.yy_gram
        P.copy_(torch.where(row, p_row.unsqueeze(1), P))
        P.copy_(torch.where(col, p_col.unsqueeze(2), P))
        P.copy_(torch.where(row & col, ys.view(nb, 1, 1), P))
        Q.copy_(torch.where(row, q_row.unsqueeze(1), Q))
        Q.copy_(torch.where(col, q_row.unsqueeze(2), Q))

    def _direction(self, st: LaneLbfgsState, lr, first) -> None:
        """lbfgs._lane_two_loop_direction ('matrix', carried Grams) with the
        coefficients on the card, and lane_lbfgs_step's opening: g·d, max
        |d|, t0, and the first trial point in the evaluation's input."""
        g = self.slots[0]
        S, Y = st.s_hist, st.y_hist
        g_h = g.to(S.dtype)
        gamma, coef_s, coef_y = klbfgs.two_loop_coefficients(
            st.sy_gram, st.yy_gram, _rows_dot(S, g_h), _rows_dot(Y, g_h),
            st.rho, self.count)
        r = (gamma.unsqueeze(1) * g + _combine(coef_s.to(S.dtype), S)
             + _combine(coef_y.to(S.dtype), Y))
        d = torch.neg(r, out=self.d)
        out = self._out
        out[_GTD0] = (g * d).sum(dim=1)
        out[_DMAX] = d.abs().amax(dim=1)
        # torch's first step opens at lr * min(1, 1 / |g|₁)
        scale = torch.clamp(torch.reciprocal(
            torch.clamp(g.abs().sum(dim=1), min=1e-20)), max=1.0)
        t0 = torch.where(first, lr * scale, lr)
        if self.unit:
            t0 = torch.where(self.count > 0, torch.ones_like(t0), t0)
        out[_T0] = t0
        torch.addcmul(self.x, t0.unsqueeze(1), d, out=self.entry.x)

    def _trial_body(self):
        self._par.copy_(self._host_in, non_blocking=True)
        torch.addcmul(self.x, self._par[_T].unsqueeze(1), self.d,
                      out=self.entry.x)
        return ()

    def _tail_body(self):
        f, g = self.entry.outputs
        nb, n = g.shape
        out = self._out
        out[_F] = f.float()
        out[_GTD] = (g * self.d).sum(dim=1)
        rows = self._par[_W].long() * nb + self._lanes
        self.slots.view(-1, n).index_copy_(0, rows, g)
        self.fslots.view(-1).index_copy_(0, rows, f.float())
        self._host_out.copy_(out, non_blocking=True)
        return ()

    # ---- the host's side ---------------------------------------------------

    def _sync(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def _launch(self, first: str, rows: Dict[int, object]) -> None:
        """Write `rows` of the pinned input (once the last launch has read
        it), then graph `first`, the evaluation and the tail under the
        evaluation's lock on the current stream, and the event."""
        self._sync()
        for row, values in rows.items():
            self._in[row] = values
        with self.entry.lock:
            for name in (first, "eval", "tail"):
                if name == "eval":
                    self.loss_grad.replay()
                    continue
                replay, launches = self._graphs[name]
                if name == "accept":
                    nb, n = self.x.shape
                    with span("lbfgs.history", lanes=nb, n=n) as history:
                        replay()
                    self._history = history
                else:
                    replay()
                kernels.add_launches(launches, self._index)
            if self._event is not None:
                self._event.record(torch.cuda.current_stream(self.x.device))

    def _read(self) -> np.ndarray:
        """The round's scalars: one wait for the event (an lbfgs.read
        span, ended by hand as lbfgs._read's)."""
        read = span("lbfgs.read")
        self._sync()
        out = self._out_np.copy()
        read.end()
        if self._history is not None:
            self._history.set(pairs=int(out[_PAIRS].sum()))
            self._history = None
        return out

    def _open(self, t_acc, acc, lr, first) -> None:
        """Launch (a): accept t_acc from slots acc, open a step at lr."""
        lr = np.asarray(lr, _f32)
        first = np.asarray(first, bool)
        self._launch("accept", {_T_ACC: t_acc, _ACC: acc, _LR: lr,
                                _FIRST: first, _W: 1.0})
        self._pending = (lr.copy(), first.copy())

    def _claim(self, lane: int) -> _Slot:
        """A free trial slot of `lane`, held until its _Slot is dropped."""
        held = self._held[lane]
        for i in range(1, SLOTS):
            if held[i] is None or held[i]() is None:
                slot = _Slot(i)
                held[i] = weakref.ref(slot)
                return slot
        raise RuntimeError("no free gradient slot: a search holds at most "
                           f"{SLOTS - 2} trials")

    def settle(self) -> None:
        """The host's pair counts (state.count) as the card has them, for
        whoever reads the state outside a step; waits for the card."""
        self.state.count = self.count.cpu().numpy().astype(np.int64)

    def step(self, x: torch.Tensor, lr,
             next_lr: Callable[[], np.ndarray]):
        """One L-BFGS iteration of every lane, with lane_lbfgs_step's
        decisions; lr: (B,) float32. next_lr() gives the next step's lr
        once this step's evaluations are counted, for the next step's
        opening. Returns (x, the (B,) losses at it): x is this object's
        buffer, which the next step updates in place."""
        st = self.state
        nb = st.rho.shape[0]
        lr = np.asarray(lr, _f32)
        with span("lbfgs.step", lanes=nb, path="card") as step:
            first = np.broadcast_to(np.asarray(st.n_iter) == 0, (nb,))
            if x is not self.x:
                self.x.copy_(x)
                self._pending = None
            if (self._pending is None
                    or not np.array_equal(self._pending[0], lr)
                    or not np.array_equal(self._pending[1], first)):
                self._open(np.zeros((nb,), _f32), np.zeros((nb,)), lr, first)
            with span("lbfgs.search") as search:
                found = self._search(nb)
                t = np.zeros((nb,), _f32)
                f_new = st.f.copy()
                acc = np.zeros((nb,), np.int64)
                ls_evals = np.zeros((nb,), np.int64)
                for b, (tb, fb, gb, evals) in found.items():
                    t[b], f_new[b], acc[b], ls_evals[b] = tb, fb, gb.index, evals
                del found
                rounds = int(ls_evals.max())
                search.set(rounds=rounds, evals=int(ls_evals.sum()))
            st.f = f_new
            st.n_evals += ls_evals
            st.n_iter += 1
            self._open(t, acc, next_lr(),
                       np.broadcast_to(np.asarray(st.n_iter) == 0, (nb,)))
            step.set(evals=rounds)
        return self.x, self.fslots[0].clone()

    def _search(self, nb: int) -> Dict[int, tuple]:
        """Every lane's strong-Wolfe search from the opened step's first
        evaluation: {lane: (t, f_t, _Slot of g_t, n_evals)}, skipping the
        lanes whose slope is not below -tolerance (torch's no-op step)."""
        out = self._read()
        f0 = self.state.f
        gtd0 = out[_GTD0]
        skip = gtd0 > -_TOL_CHANGE
        g0 = _Slot(0)
        self._held = [[None] * SLOTS for _ in range(nb)]
        written = [self._claim(b) for b in range(nb)]  # slot 1: (a)'s
        searches = {}
        t_now = np.zeros((nb,), _f32)
        for b in np.flatnonzero(~skip).tolist():
            searches[b] = _wolfe_search(f0[b], g0, gtd0[b], out[_DMAX][b],
                                        out[_T0][b], self.max_ls)
            t_now[b] = next(searches[b])
        results = {}
        while True:
            for b in list(searches):
                try:
                    t_now[b] = searches[b].send((_f32(out[_F][b]), written[b],
                                                 _f32(out[_GTD][b])))
                except StopIteration as done:
                    results[b] = done.value
                    del searches[b]
                    t_now[b] = 0.0
            written = None
            if not searches:
                return results
            written = [self._claim(b) for b in range(nb)]
            self._launch("trial", {_T: t_now,
                                   _W: [slot.index for slot in written]})
            out = self._read()
