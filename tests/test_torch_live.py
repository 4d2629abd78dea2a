"""Live serving's engine side in the port, on the CPU: per-lane start steps
(BatchedTransferJob.chunk_steps), the state transplant of a rebuild and
parallel/live.py's LiveBatchRunner, against the JAX package's
LiveBatchRunner (parallel/live.py) and against the port's own batched
chunk. Mirrors tests/test_online.py:232-317 at its shapes (levels_num=1,
base_diameter=16, 48x64 contents, seeded VGG19 weights).

Tolerances: a joined job against the same job alone, rtol 1e-4 / atol
1e-5 (the JAX package's: lanes of other batch sizes sum in other
orders). The port against the JAX package's runner: losses rtol 1e-4 and
images atol 1e-4 for Adam; unit-opening L-BFGS carries each evaluation's
~1e-6 cross-framework noise into its t = 1 steps, so losses rtol 1e-3
and images atol 1e-2 (tests/test_torch_batch.py's gates), on inputs whose
line searches decide alike in both packages. Uniform start steps and the
transplant are checked bit for bit.

Also one test per fixed fault of the JAX package's live runner (ROADMAP
Queue 3): no rebuild when every join overflowed, and no lane past
iters_num.
"""

import time

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.parallel.live import LiveBatchRunner as JRunner
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import graphs
from artstyletransfer_tpu_torch.engine import transfer as ttransfer
from artstyletransfer_tpu_torch.engine import warmup as twarmup
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel.live import LiveBatchRunner
from artstyletransfer_tpu_torch.parallel.mesh import jobs_mesh
from artstyletransfer_tpu_torch.utils.image import unprepare_img

SMALL = dict(levels_num=1, base_diameter=16)
ADAM = dict(SMALL, optimizer="adam", iters_num=20, stream_every=5)
LBFGS_UNIT = dict(SMALL, optimizer="lbfgs", lbfgs_t_init="unit",
                  lbfgs_history=4, lbfgs_grams="incremental", iters_num=6,
                  stream_every=2)


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
    """tests/test_online.py's live-runner images."""
    rng = np.random.default_rng(7)
    c1 = rng.random((48, 64, 3)).astype(np.float32)
    c2 = np.random.default_rng(123).random((48, 64, 3)).astype(np.float32)
    s = rng.random((40, 40, 3)).astype(np.float32)
    return c1, c2, s


def _runner(cfg, params, **kw):
    return LiveBatchRunner(cfg, params=params, device="cpu", **kw)


def _drain(r):
    """Step until idle: ({tid: (image, loss)}, [dispatched batch sizes])."""
    finished, sizes = {}, []
    while r.active:
        rep = r.step()
        sizes.append(rep.batch)
        finished.update(rep.finished)
    return finished, sizes


def _joined_run(runner, c1, c2, s):
    """A starts; B joins after A's first chunk; both run to the end."""
    runner.submit("A", c1, s)
    runner.step()
    runner.submit("B", c2, s)
    return _drain(runner)[0]


def test_live_runner_join_budget_and_exit(vgg_params, pair):
    """A task submitted mid-flight joins at the next chunk boundary (batch
    1 -> 2), runs its full budget offset from the first task's, and each
    lane exits at its own 100% (the JAX package's test)."""
    c1, c2, s = pair
    r = _runner(Config(**ADAM), vgg_params, chunk=5)
    r.submit("A", c1, s)
    rep = r.step()
    assert rep.joined == ["A"] and rep.batch == 1
    assert [(t, p) for t, p, _i, _l in rep.progress] == [("A", 25.0)]
    r.submit("B", c2, s)
    rep = r.step()
    assert rep.joined == ["B"] and rep.batch == 2
    assert [(t, p) for t, p, _i, _l in rep.progress] == [("A", 50.0),
                                                         ("B", 25.0)]
    finished, sizes = _drain(r)
    assert [1, 2] + sizes == [1, 2, 2, 2, 1]
    assert sorted(finished) == ["A", "B"]
    for img, loss in finished.values():
        assert img.shape == (16, 21, 3) and np.isfinite(loss)
    assert r._specs == {} and r.lanes_reserved == 0


@pytest.mark.parametrize("kw", [ADAM, LBFGS_UNIT], ids=["adam", "lbfgs"])
def test_live_runner_joined_job_matches_solo(vgg_params, pair, kw):
    """Joining does not change a job's math: B joined mid-flight against
    B alone (the same init seed), rtol 1e-4 / atol 1e-5."""
    c1, c2, s = pair
    cfg = Config(**kw)
    res = _joined_run(_runner(cfg, vgg_params), c1, c2, s)
    solo = _runner(cfg, vgg_params)
    solo._arrivals = 1  # B's init-noise seed in the joined run
    solo.submit("B", c2, s)
    res2 = _drain(solo)[0]
    np.testing.assert_allclose(res["B"][0], res2["B"][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res["B"][1], res2["B"][1], rtol=1e-4)


@pytest.mark.parametrize("kw,loss_rtol,img_atol,data_seed",
                         [(ADAM, 1e-4, 1e-4, None),
                          (LBFGS_UNIT, 1e-3, 1e-2, 0)],
                         ids=["adam", "lbfgs_unit_grams"])
def test_live_runner_matches_jax(vgg_params, pair, kw, loss_rtol, img_atol,
                                 data_seed):
    """The same joined run through the JAX package's LiveBatchRunner and
    the port's: every job's final image and loss (iters_num a multiple of
    the chunk, where the JAX package's last chunk does not overshoot).
    L-BFGS's line search branches on float32 comparisons of ~1e7-sized
    losses, so its case runs on seeded images of the same shapes whose
    searches make the same decisions in both packages (as in
    tests/test_torch_batch.py); on others one decision apart the
    trajectories part by percents in both directions."""
    c1, c2, s = pair
    if data_seed is not None:
        rng = np.random.default_rng(data_seed)
        c1, c2, s = (rng.random(a.shape).astype(np.float32) for a in pair)
    theirs = JRunner(JConfig(**kw), params=vgg_params)
    ours = _joined_run(_runner(Config(**kw), vgg_params), c1, c2, s)
    theirs.submit("A", c1, s)
    theirs.step()
    theirs.submit("B", c2, s)
    ref = {}
    while theirs.active:
        ref.update(theirs.step().finished)
    assert sorted(ours) == sorted(ref) == ["A", "B"]
    for tid in ours:
        np.testing.assert_allclose(ours[tid][1], ref[tid][1],
                                   rtol=loss_rtol)
        np.testing.assert_allclose(ours[tid][0], ref[tid][0], rtol=1e-3,
                                   atol=img_atol)


def test_live_runner_stop_tol_exits_converged_lane(vgg_params, pair):
    """stop_tol: a lane whose chunk change latches under tol leaves at the
    boundary with percent 100 (tol so loose that the second chunk
    latches)."""
    c1, _c2, s = pair
    r = _runner(Config(**dict(ADAM, iters_num=100, stop_tol=1e9)),
                vgg_params, chunk=5)
    r.submit("A", c1, s)
    rep1 = r.step()
    assert rep1.finished == {} and rep1.progress[0][1] == 5.0
    rep2 = r.step()
    assert "A" in rep2.finished and rep2.progress[0][1] == 100.0
    assert not r.active


@pytest.mark.parametrize("kw", [dict(optimizer="adam"),
                                dict(optimizer="lbfgs", lbfgs_history=3,
                                     lbfgs_grams="incremental")],
                         ids=["adam", "lbfgs"])
def test_uniform_start_steps_are_the_batched_chunk(vgg_params, pair, kw):
    """chunk_steps with every lane at the same start step gives
    BatchedTransferJob.run's chunks bit for bit, at step 0 and after."""
    c1, c2, s = pair
    cfg = Config(**dict(SMALL, iters_num=6, stream_every=3, **kw))
    chunks = list(pbatch.BatchedTransferJob([c1, c2], [s, s], cfg,
                                            params=vgg_params,
                                            device="cpu").run())
    bj = pbatch.BatchedTransferJob([c1, c2], [s, s], cfg, params=vgg_params,
                                   device="cpu")
    x = bj._x0.clone()
    opt = bj.init_opt(x)
    for start, (done, imgs, losses) in zip((0, 3), chunks):
        x, f = bj.chunk_steps(x, opt, np.full((2,), start), 3)
        assert done == start + 3
        np.testing.assert_array_equal(f.numpy(), losses)
        rows = x.reshape((2,) + bj.level_shapes[0][1:]).numpy()
        np.testing.assert_array_equal(
            np.stack([unprepare_img(r) for r in rows]), imgs)


@pytest.mark.parametrize("kw", [dict(optimizer="adam"),
                                dict(optimizer="lbfgs", lbfgs_history=3,
                                     lbfgs_grams="incremental",
                                     lbfgs_state_dtype="bfloat16")],
                         ids=["adam", "lbfgs_grams_bf16"])
def test_transplant_keeps_every_survivor_leaf(vgg_params, pair, kw):
    """A rebuild that drops lane 1 of three and adds a joiner moves lanes
    0 and 2 to rows 0 and 1: every named leaf of the optimizer (Adam's
    mu/nu/count; the whole L-BFGS lane state, carried Grams and bfloat16
    pairs included) and x, bit for bit; the joiner starts at step 0."""
    c1, c2, s = pair
    cfg = Config(**dict(SMALL, iters_num=20, stream_every=2, **kw))
    r = _runner(cfg, vgg_params)
    for tid, c in (("A", c1), ("B", c2), ("C", c1[::-1].copy())):
        r.submit(tid, c, s)
    r.step()
    r.step()
    before = dict(pbatch.lane_leaves(r._opt, r._bj.batch), x=r._x)
    specs = type(r._opt).leaf_specs(cfg, r._bj.batch, r._x.shape[1])
    assert set(before) == set(specs) | {"x"}
    before = {k: v.clone() for k, v in before.items()}
    r._exited = {1}
    r._rebuild([("D", c2, s)])
    after = dict(pbatch.lane_leaves(r._opt, r._bj.batch), x=r._x)
    assert r._lane_tid == ["A", "C", "D", None]
    assert r._lane_steps.tolist() == [4, 4, 0, 0]
    for name, leaf in before.items():
        assert after[name].dtype == leaf.dtype, name
        assert torch.equal(after[name][:2], leaf[[0, 2]]), name
    if cfg.optimizer == "adam":
        assert after["count"].tolist() == [4, 4, 0, 0]
    else:
        assert after["n_iter"].tolist() == [4, 4, 0, 0]
        assert torch.equal(after["s_hist"][2:],
                           torch.zeros_like(after["s_hist"][2:]))
    rep = r.step()  # the mixed-step chunk runs
    assert [t for t, *_ in rep.progress] == ["A", "C", "D"]


def test_trimmed_joins_do_not_rebuild(vgg_params, pair, monkeypatch):
    """Fault 1 of the JAX package (parallel/live.py:222-239): with the
    batch at its capacity, a join that overflows waits and the batch is
    not rebuilt (no targets computed again) until a lane leaves."""
    c1, c2, s = pair
    built = []
    real = pbatch.BatchedTransferJob

    class Spy(real):
        def __init__(self, contents, *a, **kw):
            built.append(len(contents))
            super().__init__(contents, *a, **kw)

    monkeypatch.setattr(pbatch, "BatchedTransferJob", Spy)
    r = _runner(Config(**dict(ADAM, iters_num=4, stream_every=2)),
                vgg_params, max_batch=1)
    r.submit("A", c1, s)
    r.step()
    r.submit("B", c2, s)
    rep = r.step()  # A's last chunk: B overflowed
    assert built == [1] and "A" in rep.finished
    assert r.all_tids == ["A", "B"] and rep.joined == []
    finished, _sizes = _drain(r)
    assert built == [1, 1] and sorted(finished) == ["B"]


def test_last_chunk_stops_at_the_budget(vgg_params, pair, monkeypatch):
    """Fault 2 of the JAX package (parallel/live.py:244-254): with
    iters_num=7 and chunk 5 no lane takes more than 7 steps; a joiner's
    lane finishes at its own 7th step."""
    c1, c2, s = pair
    chunks = []
    real = pbatch.BatchedTransferJob.chunk_steps

    def spy(self, x, opt, start_steps, n_steps):
        chunks.append((list(start_steps), n_steps))
        return real(self, x, opt, start_steps, n_steps)

    monkeypatch.setattr(pbatch.BatchedTransferJob, "chunk_steps", spy)
    r = _runner(Config(**dict(ADAM, iters_num=7, stream_every=5)),
                vgg_params)
    r.submit("A", c1, s)
    rep = r.step()
    assert [p for _t, p, _i, _l in rep.progress] == [pytest.approx(500 / 7)]
    r.submit("B", c2, s)
    reports = []
    while r.active:
        reports.append(r.step())
        opt = r._opt
        if opt is not None:
            assert max(np.atleast_1d(opt.count)) <= 7
    assert chunks == [([0], 5), ([5, 0], 2), ([2], 5)]
    assert reports[0].finished.keys() == {"A"}
    assert reports[-1].finished.keys() == {"B"}
    assert [p for t, p, _i, _l in reports[0].progress if t == "B"] == [
        pytest.approx(200 / 7)]


def test_runner_refuses_a_mesh_and_needs_cuda_by_default(monkeypatch):
    """A value that is not a mesh raises; a jobs mesh is taken (the live
    path on a mesh: tests/test_torch_mesh.py); CUDA is the default."""
    with pytest.raises(TypeError, match="mesh"):
        LiveBatchRunner(Config(**ADAM), mesh=object(), device="cpu")
    mesh = jobs_mesh(devices=["cpu", "cpu"])
    r = LiveBatchRunner(Config(**ADAM), mesh=mesh, device="cpu")
    assert r.mesh is mesh and r._capacity((32, 32, 3)) == 8
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveBatchRunner(Config(**ADAM))


def test_take_all_returns_live_and_pending_tasks(vgg_params, pair):
    """take_all gives back every task the runner holds (live lanes and
    queued joins, not the ones that finished) and leaves it empty."""
    c1, c2, s = pair
    r = _runner(Config(**dict(ADAM, iters_num=4, stream_every=2)),
                vgg_params)
    r.submit("A", c1, s)
    r.step()
    r.submit("B", c2, s)
    tasks = r.take_all()
    assert [t[0] for t in tasks] == ["A", "B"]
    assert tasks[0][1] is c1 and tasks[1][1] is c2
    assert not r.active and r.all_tids == [] and r.fail_all() == []


@pytest.fixture
def graphed(monkeypatch):
    """Graphs on for CPU jobs (the eager-replay seam), from an empty
    cache."""
    for mod in (ttransfer, pbatch):
        monkeypatch.setattr(mod, "use_graphs", lambda device, graphs: True)
    ttransfer._COMPILE_CACHE.clear()
    yield
    ttransfer._COMPILE_CACHE.clear()


def test_warm_live_chunk_makes_sure_the_graph_exists(vgg_params, pair,
                                                     graphed):
    """warm_live_chunk captures the batch's evaluation when it is missing
    and nothing after a run(); a live runner of a warmed bucket captures
    nothing, through joins and leaves."""
    c1, c2, s = pair
    cfg = Config(**dict(ADAM, iters_num=4, stream_every=2))
    for size in (1, 2):
        bj = pbatch.BatchedTransferJob([c1] * size, [s] * size, cfg,
                                       params=vgg_params, device="cpu")
        assert bj.warm_live_chunk(2) == 1
        assert bj.warm_live_chunk(2) == 0
    before = graphs.CAPTURES
    _joined_run(_runner(cfg, vgg_params), c1, c2, s)
    assert graphs.CAPTURES == before
    eager = pbatch.BatchedTransferJob([c1], [s], cfg, params=vgg_params,
                                      device="cpu", graphs=False)
    assert eager.warm_live_chunk(2) == 0


def test_graphed_live_run_copies_each_batch_targets_in(vgg_params, pair,
                                                       graphed):
    """Graphed, a rebuilt batch's first replay binds its own targets: a
    job that joins a batch of another style runs against its own style
    (a replay against the old batch's targets would give it A's)."""
    c1, c2, s = pair
    s2 = np.random.default_rng(9).random(s.shape).astype(np.float32)
    cfg = Config(**dict(ADAM, iters_num=4, stream_every=2))
    r = _runner(cfg, vgg_params)
    r.submit("A", c1, s)
    r.step()
    r.submit("B", c2, s2)
    res = _drain(r)[0]
    solo = _runner(cfg, vgg_params)
    solo._arrivals = 1
    solo.submit("B", c2, s2)
    ref = _drain(solo)[0]
    np.testing.assert_allclose(res["B"][0], ref["B"][0], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(res["B"][1], ref["B"][1], rtol=1e-4)


@pytest.mark.parametrize("kw,warmed", [
    (dict(optimizer="adam"), True),
    (dict(optimizer="lbfgs", lbfgs_t_init="unit"), True),
    (dict(optimizer="lbfgs"), False),
], ids=["adam", "lbfgs_unit", "lbfgs_lr_opening"])
def test_warmup_warms_live_chunks_only_where_live_engages(monkeypatch, kw,
                                                          warmed):
    """Fault 5 of the JAX package (engine/warmup.py:126-130): the batched
    warmup calls warm_live_chunk only for a 'batched'-policy config; the
    lr-opening full-Wolfe L-BFGS config is served by rounds."""
    calls = []

    class Spy:
        def __init__(self, contents, styles, cfg, **kw):
            self.size = len(contents)

        def run(self, **kw):
            return iter(())

        def warm_shrink_graphs(self):
            return 0

        def warm_live_chunk(self, n_steps):
            calls.append((self.size, n_steps))
            return 0

    monkeypatch.setattr(twarmup, "BatchedTransferJob", Spy)
    cfg = Config(**dict(SMALL, iters_num=2, stream_every=2, **kw))
    twarmup.warmup_aspect_buckets(cfg, params={}, aspects=(1.0,),
                                  verbose=False, batch_sizes=(1, 2))
    assert calls == ([(1, 2), (2, 2)] if warmed else [])


def test_submits_from_threads_during_steps_lose_no_task(vgg_params, pair):
    """submit() from four threads while another thread steps the runner
    (the executor's event loop and its worker): every task finishes
    exactly once, with a short switch interval to shake out lost
    updates."""
    import sys
    import threading

    c1, _c2, s = pair
    r = _runner(Config(**dict(ADAM, iters_num=2, stream_every=1)),
                vgg_params, max_batch=4)
    finished, errors = [], []
    go = threading.Event()

    def submitter(k):
        go.wait(10)
        for i in range(3):
            r.submit(f"t{k}.{i}", c1, s)

    threads = [threading.Thread(target=submitter, args=(k,))
               for k in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        go.set()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and len(finished) < 12:
            try:
                finished.extend(r.step().finished)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)
                break
        for t in threads:
            t.join(10)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    assert sorted(finished) == sorted(f"t{k}.{i}" for k in range(4)
                                      for i in range(3))
    assert not r.active
