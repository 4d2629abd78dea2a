"""The port's L-BFGS state options against the JAX package's, on the CPU:
carried S Yᵀ / Y Yᵀ Grams (lbfgs_grams='incremental') and bfloat16 history
(lbfgs_state_dtype='bfloat16').

Tolerances. The carried Grams against JAX's _update_grams on the same
buffers: rtol 1e-5 / atol 1e-7 (tests/test_engine.py:401-440), float32
dots of the same rows summed in other orders. Stored bfloat16 pairs: bit
for bit (both round to nearest even once, when a pair is stored). The
bfloat16 direction against JAX's on the same bfloat16 history: rtol 1e-5,
both quantise g and the coefficients at the same points; against the
float32 direction: JAX's own envelope, rtol 3e-2 (tests/test_engine.py:
881-918). The port's own trajectories with carried and recomputed Grams
are held at rtol 1e-4 (the JAX package's test_engine.py:401-440).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine import lbfgs as jl
from artstyletransfer_tpu.engine.transfer import TransferJob as JTransferJob
from artstyletransfer_tpu_torch.config import Config, production_config
from artstyletransfer_tpu_torch.engine import lbfgs as tl
from artstyletransfer_tpu_torch.engine.transfer import TransferJob

M, N, LANES = 3, 200, 3
STEPS = 3 * M + 2  # past the ring wrap


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread runs them as fast as
    many, and test workers in parallel processes then do not
    oversubscribe the cores (which slowed these tests many times over)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def quadratics():
    """Per-lane SPD quadratics 0.5 xᵀA x - bᵀx (eigenvalues 0.5-50);
    lane 2 has b = 0, so from x = 0 its gradient is 0 and it never
    stores a pair."""
    rng = np.random.default_rng(5)
    A, b = [], []
    for lane in range(LANES):
        q, _ = np.linalg.qr(rng.standard_normal((N, N)))
        eig = np.geomspace(0.5, 50.0, N)
        A.append((q * eig) @ q.T)
        b.append(rng.standard_normal(N) if lane < 2 else np.zeros(N))
    return np.asarray(A, np.float32), np.asarray(b, np.float32)


def _port_loss_grad(quadratics):
    A, b = (torch.from_numpy(a) for a in quadratics)

    def lg(x):
        ax = torch.bmm(A, x.unsqueeze(2)).squeeze(2)
        return 0.5 * (x * ax).sum(1) - (b * x).sum(1), ax - b

    return lg


def _grams_of(state):
    """The exact Grams of the buffers, float32 products of the stored rows."""
    S, Y = state.s_hist.float(), state.y_hist.float()
    return torch.bmm(S, Y.transpose(1, 2)), torch.bmm(Y, Y.transpose(1, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_store_and_gram_refresh_match_jax(quadratics, monkeypatch, dtype):
    """Every step of 3 lanes (one never stores) past the ring wrap: the
    stored pairs are JAX's astype of the same s and y, bit for bit, and
    each storing lane's Grams are JAX's _update_grams of the same buffers
    and pair; a lane that does not store keeps its Grams bit for bit."""
    calls = []
    real_store = tl._store_pairs

    def store(state, lanes, s, y, ys, ys_dev):
        before = (state.sy_gram.clone(), state.yy_gram.clone(),
                  state.count.copy())
        real_store(state, lanes, s, y, ys, ys_dev)
        calls.append((before, lanes.copy(), s.clone(), y.clone(),
                      ys_dev.clone(), state))

    monkeypatch.setattr(tl, "_store_pairs", store)
    lg = _port_loss_grad(quadratics)
    x = torch.zeros((LANES, N))
    st = tl.lane_init_state(lg, x, M, track_grams=True, state_dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for step in range(STEPS):
        x, st = tl.lane_lbfgs_step(lg, x, st, np.ones(LANES, np.float32))
        assert len(calls) == step + 1
        (P0, Q0, count0), lanes, s, y, ys, _ = calls[-1]
        assert 2 not in lanes.tolist()
        for lane in range(LANES):
            if lane not in lanes:
                assert torch.equal(st.sy_gram[lane], P0[lane])
                assert torch.equal(st.yy_gram[lane], Q0[lane])
                continue
            idx = int(count0[lane] % M)
            for hist, v in ((st.s_hist, s), (st.y_hist, y)):
                want = np.asarray(jnp.asarray(v[lane].numpy()).astype(jdt))
                got = hist[lane, idx]
                assert torch.equal(got.float(),
                                   torch.from_numpy(want.astype(np.float32)))
            jp, jq = jl._update_grams(
                jnp.asarray(P0[lane].numpy()), jnp.asarray(Q0[lane].numpy()),
                jnp.asarray(st.s_hist[lane].float().numpy()).astype(jdt),
                jnp.asarray(st.y_hist[lane].float().numpy()).astype(jdt),
                jnp.asarray(s[lane].numpy()), jnp.asarray(y[lane].numpy()),
                jnp.float32(ys[lane]), jnp.int32(idx), jnp.bool_(True))
            np.testing.assert_allclose(st.sy_gram[lane].numpy(),
                                       np.asarray(jp), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} lane {lane}")
            np.testing.assert_allclose(st.yy_gram[lane].numpy(),
                                       np.asarray(jq), rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step} lane {lane}")
    assert st.count.tolist()[:2] == [STEPS, STEPS] and st.count[2] == 0
    assert st.s_hist.dtype == getattr(torch, dtype)
    assert st.rho.dtype == st.sy_gram.dtype == st.g.dtype == torch.float32


def _jax_state(st):
    """The port's lane state as the JAX package's batched LbfgsState, on
    copies: the port's step writes its buffers in place, and JAX may read
    a numpy buffer without copying it, after the call returns."""
    def arr(t):
        return (jnp.asarray(np.array(t.float().numpy()))
                if torch.is_tensor(t) else t)
    b = st.count.shape[0]
    return jl.LbfgsState(
        s_hist=arr(st.s_hist), y_hist=arr(st.y_hist), rho=arr(st.rho),
        count=jnp.asarray(st.count, jnp.int32), f=jnp.asarray(st.f),
        g=arr(st.g), n_evals=jnp.asarray(st.n_evals, jnp.int32),
        n_iter=jnp.full((b,), st.n_iter, jnp.int32),
        sy_gram=arr(st.sy_gram), yy_gram=arr(st.yy_gram))


def test_carried_grams_follow_jax_lbfgs_step_under_vmap(quadratics):
    """Each of the 3m + 2 steps from the port's state, once by the port
    and once by JAX's lbfgs_step(track_grams=True) under jax.vmap: the
    same stores, and every lane's carried Grams agree. The step's own s
    and y differ at float32 rounding between the frameworks (its
    direction's dots are summed in other orders), so an entry that
    cancels is held to 1e-6 of the largest entry; test_store_and_gram_
    refresh_match_jax holds the refresh itself on equal inputs. (A whole
    trajectory would compare ulp-level drift of x, not the Grams.)"""
    A, b = (jnp.asarray(a) for a in quadratics)

    def one(x, st, a, bb):
        def lg(z):
            az = a @ z
            return 0.5 * z @ az - bb @ z, az - bb
        return jl.lbfgs_step(lg, x, st, jnp.float32(1.0))

    jstep = jax.jit(jax.vmap(one))
    lg = _port_loss_grad(quadratics)
    x = torch.zeros((LANES, N))
    st = tl.lane_init_state(lg, x, M, track_grams=True)
    for step in range(STEPS):
        jx, jst = jax.block_until_ready(
            jstep(jnp.asarray(np.array(x.numpy())), _jax_state(st), A, b))
        x, st = tl.lane_lbfgs_step(lg, x, st, np.ones(LANES, np.float32))
        assert st.count.tolist() == np.asarray(jst.count).tolist()
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-5,
                                   atol=1e-6, err_msg=f"step {step}")
        for ours, theirs in ((st.sy_gram, jst.sy_gram),
                             (st.yy_gram, jst.yy_gram)):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-5,
                                       atol=1e-6 * np.abs(theirs).max(),
                                       err_msg=f"step {step}")
    assert st.count[2] == 0 and st.count[0] > M


def test_carried_grams_track_recompute_and_select(quadratics):
    """Carried and recomputed Grams give the same trajectory, the carried
    ones stay the exact Grams of the buffers, and select carries them with
    their lanes."""
    lg = _port_loss_grad(quadratics)
    x_r = x_i = torch.zeros((LANES, N))
    st_r = tl.lane_init_state(lg, x_r, M)
    st_i = tl.lane_init_state(lg, x_i, M, track_grams=True)
    assert st_r.sy_gram is None and st_i.sy_gram.shape == (LANES, M, M)
    lr = np.ones(LANES, np.float32)
    for step in range(STEPS):
        x_r, st_r = tl.lane_lbfgs_step(lg, x_r, st_r, lr)
        x_i, st_i = tl.lane_lbfgs_step(lg, x_i, st_i, lr)
        np.testing.assert_allclose(x_i.numpy(), x_r.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"step {step}")
        P, Q = _grams_of(st_i)
        torch.testing.assert_close(st_i.sy_gram, P, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(st_i.yy_gram, Q, rtol=1e-5, atol=1e-7)
    before = st_i.sy_gram.clone()
    st_i.select([1, 0, 0])
    assert torch.equal(st_i.sy_gram[0], before[1])
    assert torch.equal(st_i.sy_gram[2], before[0])
    lanes2 = _port_loss_grad(tuple(q[[1, 0, 0]] for q in quadratics))
    x_i = x_i[[1, 0, 0]]
    for _ in range(2):
        x_i, st_i = tl.lane_lbfgs_step(lanes2, x_i, st_i, lr)
        P, Q = _grams_of(st_i)
        torch.testing.assert_close(st_i.sy_gram, P, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(st_i.yy_gram, Q, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(x_i[1], x_i[2], rtol=0, atol=0)


def _bf16_history(count, seed=11, m=7, n=257):
    """tests/test_engine.py's history at `count` stored pairs."""
    rng = np.random.default_rng(seed + count)
    s_rows = rng.standard_normal((m, n)).astype(np.float32) * 1e-2
    y_rows = (s_rows * rng.uniform(0.5, 2.0, (m, 1)).astype(np.float32)
              + rng.standard_normal((m, n)).astype(np.float32) * 1e-3)
    k = min(count, m)
    mask = np.zeros((m, 1), np.float32)
    mask[[(count - 1 - j) % m for j in range(k)]] = 1.0
    rho = (mask[:, 0] / np.maximum(
        np.einsum("mn,mn->m", s_rows * mask, y_rows * mask),
        1e-8)).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return s_rows * mask, y_rows * mask, rho, g


@pytest.mark.parametrize("impl", ["matrix", "loop"])
@pytest.mark.parametrize("count", [1, 3, 7 + 4])
def test_bf16_direction_matches_jax(impl, count):
    s_rows, y_rows, rho, g = _bf16_history(count)

    def jstate(dt):
        return jl.LbfgsState(
            s_hist=jnp.asarray(s_rows).astype(dt),
            y_hist=jnp.asarray(y_rows).astype(dt), rho=jnp.asarray(rho),
            count=jnp.int32(count), f=jnp.float32(0.0), g=jnp.asarray(g),
            n_evals=jnp.int32(1), n_iter=jnp.int32(count))

    ref = np.asarray(jl._two_loop_direction(jnp.asarray(g),
                                            jstate(jnp.bfloat16), impl=impl))
    ref_f32 = np.asarray(jl._two_loop_direction(jnp.asarray(g),
                                                jstate(jnp.float32),
                                                impl="matrix"))
    st = tl.LbfgsState(
        s_hist=torch.from_numpy(s_rows).bfloat16(),
        y_hist=torch.from_numpy(y_rows).bfloat16(),
        rho=torch.from_numpy(rho), count=count, f=np.float32(0.0),
        g=torch.from_numpy(g), n_evals=1, n_iter=count)
    ours = tl._two_loop_direction(torch.from_numpy(g), st, impl=impl)
    assert ours.dtype == torch.float32
    ours = ours.numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(ours, ref_f32, rtol=3e-2,
                               atol=3e-2 * np.abs(ref_f32).max())


def test_state_dtype_is_checked():
    with pytest.raises(ValueError, match="float16"):
        tl.lane_init_state(lambda x: (x.sum(1), x), torch.zeros((1, 4)), 2,
                           state_dtype="float16")


def test_engine_incremental_bf16_matches_jax(vgg_params):
    """A tiny job at (incremental, bfloat16) through TransferJob: the loss
    falls, and after 3 steps it is within rtol 1e-3 of the JAX package's
    TransferJob at the same settings."""
    rng = np.random.default_rng(13)
    content = rng.random((40, 48, 3)).astype(np.float32)
    style = rng.random((32, 32, 3)).astype(np.float32)
    kw = dict(levels_num=1, iters_num=3, base_diameter=16, stream_every=3,
              optimizer="lbfgs", lbfgs_history=4, lbfgs_t_init="unit",
              lbfgs_grams="incremental", lbfgs_state_dtype="bfloat16")
    job = TransferJob(content, style, Config(**kw), params=vgg_params,
                      device="cpu")
    first = job.initial_loss()
    done, _img, loss = list(job.run())[-1]
    assert done == 3 and loss < first
    jjob = JTransferJob(content, style, JConfig(**kw), params=vgg_params)
    _d, _i, jloss = list(jjob.run())[-1]
    np.testing.assert_allclose(loss, jloss, rtol=1e-3)


def test_production_config_carries_grams_on_cuda():
    """On CUDA the deployment default carries the Grams of the matrix
    direction and keeps float32 history; on the CPU it changes nothing,
    and an explicit CLI flag wins over it."""
    cfg = production_config(Config(), device="cuda")
    assert (cfg.lbfgs_grams, cfg.lbfgs_state_dtype) == ("incremental",
                                                        "float32")
    for other in (Config(optimizer="adam"), Config(lbfgs_direction="loop")):
        assert production_config(other, device="cuda") is other
    assert production_config(Config(), device="cpu") == Config()
    from artstyletransfer_tpu_torch.frontends.cli import (build_parser,
                                                          config_from_args)

    args = ["--content", "c", "--style", "s", "--output", "o"]
    parser = build_parser()
    assert config_from_args(parser.parse_args(
        args + ["--device", "cuda"])).lbfgs_grams == "incremental"
    assert config_from_args(parser.parse_args(
        args + ["--device", "cuda", "--lbfgs-grams",
                "recompute"])).lbfgs_grams == "recompute"
    assert config_from_args(parser.parse_args(
        args + ["--device", "cpu"])).lbfgs_grams == "recompute"
