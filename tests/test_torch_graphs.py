"""The port's compiled step on the CPU: the captured-evaluation plumbing
(engine/graphs.py, engine/transfer.py's _COMPILE_CACHE, the runner
bound utils/cache.py) with the body called eagerly at each "replay".

graphs=True on the CPU runs the same static buffers, owner binding, lock,
copy-in and copy-out as a CUDA graph, so a kept gradient that aliased a
static output, or a job that replayed against another's targets, would
change the trajectory. Tolerances: the graphed and the eager trajectory
must agree bit for bit (same kernels, same inputs); against the JAX
package they keep tests/test_golden.py's multi-step gates (PSNR > 35 dB,
loss within 5%), as tests/test_torch_transfer.py does.
"""

import os
import time

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine.transfer import TransferJob as JTransferJob
from artstyletransfer_tpu.utils.cache import BoundedCache as JBoundedCache
from artstyletransfer_tpu_torch import kernels
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import graphs
from artstyletransfer_tpu_torch.engine import transfer as ttransfer
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.utils.cache import BoundedCache

BASE = dict(levels_num=2, base_diameter=16, seed=7)
RUNS = {
    "adam": dict(optimizer="adam", iters_num=6, stream_every=2),
    "lbfgs_lr": dict(optimizer="lbfgs", lbfgs_history=2, iters_num=4,
                     stream_every=2),
    "lbfgs_unit": dict(optimizer="lbfgs", lbfgs_history=2,
                       lbfgs_t_init="unit", iters_num=4, stream_every=2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread runs them as fast as many, and
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    return (rng.random((40, 48, 3)).astype(np.float32),
            rng.random((32, 32, 3)).astype(np.float32))


def psnr(a, b):
    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _trajectory(job, **kw):
    return [(d, img, np.asarray(f)) for d, img, f in job.run(**kw)]


def _assert_same(a, b):
    assert [d for d, _i, _f in a] == [d for d, _i, _f in b]
    for (_d, ia, fa), (_d2, ib, fb) in zip(a, b):
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_array_equal(fa, fb)


def load_jax_native():
    """Load the JAX package's native image library in this process if an
    earlier try failed while its file was being written.

    Each package builds its native library at its first use, and a
    package whose library does not load takes its numpy host path for the
    rest of the process. The JAX package's Makefile links the library in
    place, so a test worker that loads it while another worker's build is
    writing it fails, and keeps the numpy path. The L-BFGS trajectories
    below part on that path's last bits (the JAX job's loss moves by up
    to 17%), so the comparison loads the library again once it is
    whole."""
    import artstyletransfer_tpu.native as jax_native

    for _ in range(20):
        if jax_native.available() or os.environ.get("ASTT_NO_NATIVE"):
            return
        time.sleep(0.5)
        jax_native._tried = False  # its file may be whole now


@pytest.fixture
def jax_native_loaded():
    load_jax_native()


def _graphed_eager_and_jax(pair, vgg_params, run):
    cfg = dict(BASE, **RUNS[run])
    eager = _trajectory(TransferJob(*pair, Config(**cfg), params=vgg_params,
                                    device="cpu"))
    job = TransferJob(*pair, Config(**cfg), params=vgg_params, device="cpu",
                      graphs=True)
    graphed = _trajectory(job)
    assert job._loss_grad._graph is not None  # it really replayed
    _assert_same(graphed, eager)
    _d, j_img, j_loss = list(JTransferJob(*pair, JConfig(**cfg),
                                          params=vgg_params).run())[-1]
    for _d, img, loss in (eager[-1], graphed[-1]):
        assert psnr(img, j_img) > 35.0
        np.testing.assert_allclose(float(loss), j_loss, rtol=5e-2)


@pytest.mark.parametrize("run", list(RUNS))
def test_graphed_job_is_the_eager_job(pair, vgg_params, jax_native_loaded,
                                      run):
    """(a) One job through the static-buffer runner equals the eager job
    bit for bit at every chunk; both stay within the goldens' gates of
    the JAX package's job on the same inputs."""
    _graphed_eager_and_jax(pair, vgg_params, run)


@pytest.mark.parametrize("run", ["lbfgs_lr", "lbfgs_unit"])
def test_graphed_job_after_a_lost_native_build_race(pair, vgg_params,
                                                    monkeypatch, run):
    """The state a lost build race leaves in a test worker (the JAX
    package's loader tried once, failed, and keeps its numpy path): the
    comparison above loads the library again and passes."""
    import artstyletransfer_tpu.native as jax_native

    assert jax_native.available()  # the library is built and whole
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", True)
    assert not jax_native.available()
    load_jax_native()
    assert jax_native.available()
    _graphed_eager_and_jax(pair, vgg_params, run)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs_unit"])
def test_graphed_batch_that_shrinks_is_the_eager_batch(vgg_params, capsys,
                                                       optimizer):
    """(a) A 3-lane batch whose two black lanes (loss and gradient 0)
    latch at step 4 and leave it: the graphed batch moves to the 1-lane
    graph with the selected targets and equals the eager batch bit for
    bit."""
    # one level, contents and styles at its size: a black lane's start,
    # content and style are the same image
    rng = np.random.default_rng(5)
    content, style = rng.random((2, 16, 20, 3)).astype(np.float32)
    black = np.zeros_like(content)
    kw = dict(RUNS[optimizer], levels_num=1, base_diameter=16,
              iters_num=6, stream_every=2, stop_tol=1e-4, stop_shrink=True)

    def run(graphed):
        job = pbatch.BatchedTransferJob(
            [black, content, black], [black, style, black],
            Config(**kw),
            params=vgg_params, device="cpu", graphs=graphed,
            init_overrides=[black, content, black])
        before = graphs.CAPTURES
        out = _trajectory(job)
        assert "at step 4; batch 3 -> 1" in capsys.readouterr().err
        return out, graphs.CAPTURES - before

    eager, n_eager = run(False)
    graphed, n_graphed = run(True)
    assert n_eager == 0 and n_graphed <= 2  # 3 lanes, then 1 (if new)
    _assert_same(graphed, eager)
    assert [d for d, _i, _l in graphed] == [2, 4, 6]


def test_two_jobs_interleaved_through_one_entry(pair, vgg_params):
    """(b) Two jobs of one key step in turns through one cached entry
    (each evaluation rebinds its owner's targets) and each equals its solo
    eager run bit for bit; the second job captures nothing."""
    content, style = pair
    other = np.ascontiguousarray(content[::-1, ::-1])
    cfg = Config(**dict(BASE, **dict(RUNS["lbfgs_unit"], stream_every=1)))

    def job(c, graphed):
        return TransferJob(c, style, cfg, params=vgg_params, device="cpu",
                           graphs=graphed)

    solo = [_trajectory(job(c, False)) for c in (content, other)]
    a, b = job(content, True), job(other, True)
    before = graphs.CAPTURES
    runs = [a.run(), b.run()]
    out = [[], []]
    for _step in range(cfg.iters_num):
        for i, it in enumerate(runs):
            d, img, f = next(it)
            out[i].append((d, img, np.asarray(f)))
    assert graphs.CAPTURES - before <= 1
    assert a._loss_grad._graph is b._loss_grad._graph
    for got, want in zip(out, solo):
        _assert_same(got, want)


def test_cache_key_extends_the_config_key(pair, vgg_params):
    """The graph key is _config_key (the checkpoint fingerprint, left as
    it is) plus lanes, device and the weights' identity; jobs of one
    source share device weights, so their keys meet."""
    cfg = Config(**dict(BASE, **RUNS["adam"]))
    a = TransferJob(*pair, cfg, params=vgg_params, device="cpu",
                    graphs=True)
    b = TransferJob(*pair, cfg, params=vgg_params, device="cpu")
    assert a.params is b.params
    a._loss_grad(a._x0)
    key = list(ttransfer._COMPILE_CACHE._d)[-1]  # the most recent
    assert ttransfer._COMPILE_CACHE[key] is a._loss_grad._graph
    assert key == ttransfer._config_key(cfg, a.level_shapes) + (
        1, "cpu", id(a.params))
    c = TransferJob(*pair, cfg, params=None, device="cpu")
    assert c.params is not a.params  # another source: cfg.seed's weights


def test_capture_failure_raises_and_never_runs_eager(pair, vgg_params,
                                                     monkeypatch):
    """A failed capture raises out of the job; nothing evaluates eagerly
    in its place."""
    def broken(fn, device):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(graphs, "eager_capture", broken)
    ttransfer._COMPILE_CACHE.clear()
    cfg = Config(**dict(BASE, **RUNS["lbfgs_unit"]))
    job = TransferJob(*pair, cfg, params=vgg_params, device="cpu",
                      graphs=True)
    with pytest.raises(RuntimeError, match="capture failed"):
        next(job.run())


def test_copy_out_is_owned_and_launches_replay():
    """EvalGraph's outputs are the caller's tensors (a later replay does
    not change them); a capture's recorded launches are added to LAUNCHES
    at each replay, and a wrapper called on a capturing stream counts
    into that capture's record."""
    def body(targets, x):
        kernels.launched("tv", 7)  # as a wrapper on stream 7 would
        return (x * targets[0][0]).sum(dim=1), x * 2.0

    def capture(fn, device):
        launches = {}
        kernels.RECORDING[7] = launches
        try:
            replay, out, _ = graphs.eager_capture(fn, device)
        finally:
            del kernels.RECORDING[7]
        return replay, out, launches

    targets = ((torch.ones(2, 3), ()),)
    g = graphs.EvalGraph(body, torch.zeros(2, 3), targets, capture)
    assert g.launches == {"tv": 1}
    before = kernels.LAUNCHES["tv"]
    owner = object()
    f1, g1 = g(owner, targets, torch.ones(2, 3))
    f2, g2 = g(owner, targets, torch.zeros(2, 3),
               t=torch.full((2, 1), 3.0), d=torch.ones(2, 3))
    # the body's own launched() runs eagerly at each replay here, outside
    # any record: one count per replay from it and one from the record
    assert kernels.LAUNCHES["tv"] - before == 4
    np.testing.assert_array_equal(f1.numpy(), [3.0, 3.0])
    np.testing.assert_array_equal(g1.numpy(), np.full((2, 3), 2.0))
    np.testing.assert_array_equal(f2.numpy(), [9.0, 9.0])
    np.testing.assert_array_equal(g2.numpy(), np.full((2, 3), 6.0))
    assert g1.data_ptr() != g._g.data_ptr()
    # another owner's targets are copied in before its replay
    f3, _ = g(object(), ((torch.full((2, 3), 2.0), ()),), torch.ones(2, 3))
    np.testing.assert_array_equal(f3.numpy(), [6.0, 6.0])


def _cache_ops():
    """A sequence of sets, gets and evictions (maxsize 3)."""
    rng = np.random.default_rng(4)
    ops = []
    for i in range(40):
        key = f"k{int(rng.integers(0, 6))}"
        ops.append(("set", key, i) if rng.random() < 0.6 else ("get", key))
    return ops


@pytest.mark.parametrize("maxsize", [3, 0])
def test_bounded_cache_matches_jax(maxsize):
    """(c) The port's BoundedCache and the JAX package's, driven by the
    same sets and gets: the same hits, values, keys and LRU order after
    every operation."""
    ours, theirs = BoundedCache(maxsize), JBoundedCache(maxsize)
    for op in _cache_ops():
        if op[0] == "set":
            ours[op[1]] = op[2]
            theirs[op[1]] = op[2]
        else:
            assert (op[1] in ours) == (op[1] in theirs)
            if op[1] in theirs:
                assert ours[op[1]] == theirs[op[1]]
        assert list(ours._d.items()) == list(theirs._d.items())
        assert len(ours) == len(theirs)
    ours.clear()
    assert len(ours) == 0


def test_bounded_cache_default_bound(monkeypatch):
    monkeypatch.setenv("ASTT_RUNNER_CACHE_SIZE", "5")
    assert BoundedCache().maxsize == JBoundedCache().maxsize == 5
    monkeypatch.delenv("ASTT_RUNNER_CACHE_SIZE")
    assert BoundedCache().maxsize == JBoundedCache().maxsize == 32


def test_two_concurrent_executor_jobs_equal_their_solo_runs(pair, vgg_params,
                                                            monkeypatch):
    """Two jobs of one bucket at once through Executor (two threads, as
    config.simultaneous_tasks_count = 2 allows), both evaluating through
    one cached entry under its lock: each ends on its solo eager run's
    image bit for bit."""
    import asyncio
    from functools import partial

    from artstyletransfer_tpu_torch.engine.transfer import (
        ContentStylePair, neural_style_transfer)
    from artstyletransfer_tpu_torch.runtime.executor import Executor

    content, style = pair
    contents = {"a": content, "b": np.ascontiguousarray(content[::-1])}
    cfg = Config(**dict(BASE, **dict(RUNS["lbfgs_unit"], stream_every=1)))
    solo = {tid: list(TransferJob(c, style, cfg, params=vgg_params,
                                  device="cpu").run())[-1][1]
            for tid, c in contents.items()}
    monkeypatch.setattr(ttransfer, "use_graphs",
                        lambda device, graphs: graphs is not False)
    final = {}

    async def report(task_id, result):
        final[task_id] = result

    async def go():
        ex = Executor(cfg, report_progress=report, verbose=False,
                      engine=partial(neural_style_transfer,
                                     params=vgg_params), device="cpu")
        for tid, c in contents.items():
            await ex.add_task(tid, ContentStylePair(("c", c), ("s", style)))
        await ex.run()
        assert not ex.failures

    asyncio.run(go())
    for tid in contents:
        percent, img = final[tid]
        assert percent == 100.0
        np.testing.assert_array_equal(img, solo[tid])
