"""The port's jobs mesh (parallel/mesh.py, parallel/shards.py) on the CPU.

The CPU is one torch device, so a mesh of [cpu, cpu] stands in for the
JAX package's virtual devices: the shard threads, the per-shard batches,
the lanes' moves between shards and the sharded checkpoint all run, on
one device. Tolerances: a batch on a mesh against the same batch with no
mesh, losses rtol 1e-5 and images atol 1e-4 (each shard is a one-card
batch of its lanes, and lanes are independent: tests/test_torch_batch.py's
lockstep test; a shard of fewer lanes runs the convolutions at another
batch size, which moves the last bits); against the JAX package's
BatchedTransferJob(mesh=jobs_mesh(2)), test_torch_batch.py's batch
tolerances (losses rtol 1e-3, images rtol/atol 1e-3, atol 1e-2 after
unit-opening L-BFGS). A CUDA mesh is built here with torch.cuda's card
count patched, which makes no CUDA call.
"""

import asyncio
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine import checkpoint as jckpt
from artstyletransfer_tpu.engine import warmup as jwarmup
from artstyletransfer_tpu.parallel import batch as jbatch
from artstyletransfer_tpu.parallel import jobs_mesh as jjobs_mesh
from artstyletransfer_tpu_torch import kernels
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import warmup as twarmup
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel import memory as pmemory
from artstyletransfer_tpu_torch.parallel.live import LiveBatchRunner
from artstyletransfer_tpu_torch.parallel.mesh import (
    Mesh, default_serving_mesh, jobs_mesh, jobs_space_mesh,
    multislice_jobs_space_mesh)
from artstyletransfer_tpu_torch.parallel.shards import Lanes
from artstyletransfer_tpu_torch.runtime.online import OnlineBatchingExecutor

CPU2 = ["cpu", "cpu"]
SMALL = dict(levels_num=1, base_diameter=16)
RUNS = {"adam": dict(optimizer="adam"),
        "lbfgs_unit": dict(optimizer="lbfgs", lbfgs_t_init="unit",
                           lbfgs_history=3)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread runs them as fast as many, and
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def same_native(monkeypatch):
    """Both packages on the same host resize path (see test_torch_ops)."""
    import artstyletransfer_tpu.native as jax_native
    import artstyletransfer_tpu_torch.native as port_native

    if jax_native.available() != port_native.available():
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)


@pytest.fixture
def eight_cards(monkeypatch):
    """torch.cuda reports 8 cards (no CUDA call is made)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


@pytest.fixture(scope="module")
def jobs_data():
    """tests/test_parallel.py's jobs."""
    rng = np.random.default_rng(11)
    contents = [rng.random((32, 48, 3)).astype(np.float32) for _ in range(4)]
    styles = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(4)]
    return contents, styles


def _final(job, **kw):
    return list(job.run(**kw))[-1]


def _assert_close(ours, plain):
    """Two runs' chunks: the same steps; losses rtol 1e-5, images atol
    1e-4 (see the module docstring)."""
    assert [d for d, _i, _l in ours] == [d for d, _i, _l in plain]
    for (_d, ia, la), (_d2, ib, lb) in zip(ours, plain):
        np.testing.assert_allclose(la, lb, rtol=1e-5)
        np.testing.assert_allclose(ia, ib, rtol=0, atol=1e-4)


# ---- mesh construction ----------------------------------------------------


def test_mesh_shapes_and_checks_match_jax(eight_cards):
    """jobs_mesh / jobs_space_mesh / multislice_jobs_space_mesh: the JAX
    package's shapes and checks (tests/test_parallel.py), over 8 cards."""
    cards = [torch.device("cuda", i) for i in range(8)]
    m = jobs_mesh()
    assert m.axis_names == ("jobs",) and m.shape == {"jobs": 8}
    assert m.devices == tuple(cards)
    assert jobs_mesh(4).devices == tuple(cards[:4])
    with pytest.raises(ValueError, match="visible"):
        jobs_mesh(9)
    m = jobs_space_mesh(2, 2)
    assert m.shape == {"jobs": 2, "space": 2}
    assert m.jobs_devices() == (cards[0], cards[2])
    with pytest.raises(ValueError):
        jobs_space_mesh(4, 4)
    # two pretend 4-card slices, not in device order: the rows of each
    # slice stay whole and stack slice-major
    m = multislice_jobs_space_mesh(2, slice_devices=[cards[4:], cards[:4]])
    assert m.shape == {"jobs": 4, "space": 2}
    assert m.devices == tuple(cards[4:] + cards[:4])
    assert multislice_jobs_space_mesh(2).shape == {"jobs": 4, "space": 2}
    for bad in (dict(n_space=3),  # 8 cards do not split by 3
                dict(n_space=2, slice_devices=[cards[:3], cards[3:6]]),
                dict(n_space=0)):
        with pytest.raises(ValueError):
            multislice_jobs_space_mesh(**bad)
    for devs in (["cpu", "cuda:0"], ["cuda"], ["cuda:8"]):
        with pytest.raises(ValueError):
            jobs_mesh(devices=devs)
    # the JAX package's shapes on its 8 virtual devices
    assert dict(jjobs_mesh(4).shape) == jobs_mesh(4).shape


def test_meshes_need_cards_or_explicit_devices():
    """With no card visible a mesh is built only from explicit devices; a
    repeated device is allowed (the CPU stand-in)."""
    for make in (jobs_mesh, lambda: jobs_space_mesh(1, 1),
                 multislice_jobs_space_mesh):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    m = jobs_mesh(devices=CPU2)
    assert isinstance(m, Mesh) and m.shape == {"jobs": 2} and m.size == 2


def test_default_serving_mesh_env_gate(monkeypatch, eight_cards):
    """The JAX package's gate (tests/test_parallel.py): 'none' (the
    suite's setting) gives None, 'auto' every card, anything else raises;
    fewer than two cards, or the CPU, give None."""
    assert default_serving_mesh() is None
    monkeypatch.setenv("ASTT_SERVING_MESH", "auto")
    assert default_serving_mesh().shape == {"jobs": 8, "space": 1}
    assert default_serving_mesh(2).shape == {"jobs": 4, "space": 2}
    monkeypatch.setenv("ASTT_SERVING_MESH", "bogus")
    with pytest.raises(ValueError):
        default_serving_mesh()
    monkeypatch.setenv("ASTT_SERVING_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert default_serving_mesh() is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_serving_mesh() is None


# ---- a batch on a mesh ----------------------------------------------------


@pytest.mark.parametrize("kw,iters,data_seed", [
    (dict(optimizer="adam"), 6, 11),
    (dict(optimizer="lbfgs", lbfgs_t_init="unit", lbfgs_history=3), 3, 4),
], ids=["adam", "lbfgs_unit"])
def test_batch_on_mesh_matches_unsharded_and_jax(vgg_params, same_native,
                                                 kw, iters, data_seed):
    """test_torch_batch.py's two batched jobs and two more, on a 2-shard
    mesh: each chunk of the four lanes against the same batch with no
    mesh; the two jobs, one lane a shard, within test_torch_batch.py's
    tolerances of the JAX package's batch on jobs_mesh(2), on the data
    that test holds against the JAX package (other data parts the
    packages' first L-BFGS steps: ROADMAP Queue 3)."""
    rng = np.random.default_rng(data_seed)
    width = 48 if data_seed == 11 else 40

    def draw(n, shape):
        return [rng.random(shape).astype(np.float32) for _ in range(n)]

    contents, styles = draw(2, (32, width, 3)), draw(2, (24, 24, 3))
    contents, styles = (contents + draw(2, (32, width, 3)),
                        styles + draw(2, (24, 24, 3)))
    base = dict(levels_num=2, iters_num=iters, base_diameter=16,
                stream_every=iters, **kw)
    chunks = Config(**dict(base, stream_every=iters // 3))
    mesh = jobs_mesh(devices=CPU2)
    sharded = pbatch.BatchedTransferJob(contents, styles, chunks,
                                        params=vgg_params, mesh=mesh)
    assert [s.batch for s in sharded.shards] == [2, 2]
    ours = list(sharded.run())
    plain = list(pbatch.BatchedTransferJob(contents, styles, chunks,
                                           params=vgg_params,
                                           device="cpu").run())
    assert len(ours) == 3
    _assert_close(ours, plain)
    _d, j_imgs, j_losses = _final(jbatch.BatchedTransferJob(
        contents[:2], styles[:2], JConfig(**base), params=vgg_params,
        mesh=jjobs_mesh(2)))
    _d, imgs, losses = _final(pbatch.BatchedTransferJob(
        contents[:2], styles[:2], Config(**base), params=vgg_params,
        mesh=mesh))
    img_tol = 1e-2 if kw.get("lbfgs_t_init") == "unit" else 1e-3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    np.testing.assert_allclose(imgs, j_imgs, rtol=1e-3, atol=img_tol)


def test_batch_padding_to_mesh(jobs_data, vgg_params):
    """3 jobs on a 2-wide jobs mesh: padded to 4 lanes, 3 results out
    (the JAX package's test_batch_padding_to_mesh); with yield_images off
    the intermediate losses come over every lane, on the host."""
    contents, styles = jobs_data
    cfg = Config(**SMALL, iters_num=4, stream_every=2, optimizer="adam")
    batch = pbatch.BatchedTransferJob(contents[:3], styles[:3], cfg,
                                      params=vgg_params,
                                      mesh=jobs_mesh(devices=CPU2))
    assert batch.batch == 4 and batch.real_batch == 3
    assert batch.initial_losses().shape == (3,)
    out = list(batch.run(yield_images=False))
    assert out[0][1] is None and tuple(out[0][2].shape) == (4,)
    done, imgs, losses = out[-1]
    assert done == 4 and imgs.shape[0] == 3 and losses.shape == (3,)


def test_a_failing_shard_fails_the_batch(jobs_data, vgg_params,
                                         monkeypatch):
    """A shard that raises (here the one in the second shard thread) fails
    its batch once every shard has stopped, with no result from the other
    card, and run_job_queue records the failure for every job of the
    group."""
    contents, styles = jobs_data
    cfg = Config(**SMALL, iters_num=2, stream_every=2, optimizer="adam")
    real = pbatch._ONE_CARD._steps
    ran = []

    def steps(self, x, opt, done, k):
        name = threading.current_thread().name
        if name.startswith("astt-shard-cpu-1"):
            raise RuntimeError("card lost")
        if name.startswith("astt-shard"):
            ran.append(name)
        return real(self, x, opt, done, k)

    monkeypatch.setattr(pbatch._ONE_CARD, "_steps", steps)
    b = pbatch.BatchedTransferJob(contents[:2], styles[:2], cfg,
                                  params=vgg_params,
                                  mesh=jobs_mesh(devices=CPU2))
    with pytest.raises(RuntimeError, match="card lost"):
        list(b.run())
    assert len(ran) == 1 and ran[0].startswith("astt-shard-cpu-0")
    jobs = [("a", contents[0], styles[0]), ("b", contents[1], styles[1])]
    results, failures = pbatch.run_job_queue(
        jobs, cfg, params=vgg_params, mesh=jobs_mesh(devices=CPU2))
    assert results == {} and set(failures) == {"a", "b"}


def test_job_queue_split_is_mesh_aware(vgg_params, rng, monkeypatch):
    """The JAX package's test: on a jobs mesh the automatic cap is the
    one-card cap times the axis (groups [4, 1] with the mesh kept), and
    sequential groups of one job drop the mesh; the round sizes a queue
    plans match the JAX package's on a jobs axis of 2."""
    calls = []
    orig = pbatch.BatchedTransferJob

    class Recorder(orig):
        def __init__(self, contents, styles, *a, **kw):
            calls.append((len(contents), kw.get("mesh")))
            super().__init__(contents, styles, *a, **kw)

    monkeypatch.setattr(pbatch, "BatchedTransferJob", Recorder)
    monkeypatch.setattr(pbatch, "max_jobs_per_batch",
                        lambda cfg, shape, space=1: 2)
    content = rng.random((24, 24, 3)).astype(np.float32)
    style = rng.random((16, 16, 3)).astype(np.float32)
    jobs = [(f"t{i}", content.copy(), style.copy()) for i in range(5)]
    mesh = jobs_mesh(devices=CPU2)
    cfg = Config(**SMALL, iters_num=2, stream_every=2, optimizer="adam")
    results, failures = pbatch.run_job_queue(jobs, cfg, params=vgg_params,
                                             mesh=mesh)
    assert failures == {} and len(results) == 5
    assert [c[0] for c in calls] == [4, 1]
    assert all(c[1] is mesh for c in calls)
    calls.clear()
    cfg_fw = Config(**SMALL, iters_num=1, stream_every=1, optimizer="lbfgs",
                    lbfgs_history=2, lbfgs_max_ls_steps=2)
    results, failures = pbatch.run_job_queue(jobs[:2], cfg_fw,
                                             params=vgg_params, mesh=mesh)
    assert failures == {} and len(results) == 2
    assert calls == [(1, None), (1, None)]
    monkeypatch.undo()
    for kw in (dict(optimizer="adam"),
               dict(optimizer="adam", stop_tol=0.01, stop_shrink=True),
               dict(optimizer="lbfgs", lbfgs_t_init="unit")):
        for n, max_batch in ((5, None), (7, 6), (3, 8)):
            args = ((32, 32, 3), n)
            theirs = jbatch.planned_round_sizes(
                JConfig(**SMALL, **kw), *args, jobs_axis=2,
                max_batch=max_batch)
            ours = pbatch.planned_round_sizes(
                Config(**SMALL, **kw), *args, jobs_axis=2,
                max_batch=max_batch)
            assert ours == theirs, (kw, n, max_batch)


def _black_lanes():
    """Four one-level jobs whose contents and styles are at the level's
    size, so that a content is also its lane's init image; lanes 0 and 1
    black (loss and gradient 0: they latch at the second check)."""
    rng = np.random.default_rng(5)
    c2, c3, s2, s3 = rng.random((4, 16, 20, 3)).astype(np.float32)
    black = np.zeros_like(c2)
    cs = [black, black, c2, c3]
    return cs, [black, black, s2, s3], cs


def test_stop_shrink_on_jobs_mesh(vgg_params, capsys):
    """Convergence shrinking on a jobs mesh: two black lanes (loss and
    gradient 0) latch at step 4 and leave; the two jobs left re-form at
    shrink_target(2, 2) = 2 lanes, one per shard, so job 2 moves from
    shard 1 to shard 0. Frozen jobs stay bit-stable, survivors keep
    improving, and every chunk is within the module's tolerance of the
    batch with no mesh."""
    cs, ss, inits = _black_lanes()
    cfg = Config(**SMALL, iters_num=8, stream_every=2, optimizer="adam",
                 stop_tol=1e-4, stop_shrink=True)
    b = pbatch.BatchedTransferJob(cs, ss, cfg, params=vgg_params,
                                  mesh=jobs_mesh(devices=CPU2),
                                  init_overrides=inits, graphs=True)
    assert b.warm_shrink_graphs() == 1  # one lane a shard
    out = list(b.run())
    assert "at step 4; batch 4 -> 2" in capsys.readouterr().err
    plain = list(pbatch.BatchedTransferJob(cs, ss, cfg, params=vgg_params,
                                           device="cpu",
                                           init_overrides=inits).run())
    _assert_close(out, plain)
    losses = {d: l for d, _i, l in out}
    assert (losses[8][:2] == losses[4][:2]).all()
    assert (losses[8][2:] < losses[4][2:]).all()


@pytest.mark.parametrize("run", list(RUNS))
def test_checkpoint_on_mesh_resumes_and_reads_as_unsharded(
        vgg_params, tmp_path, run):
    """A sharded batch that shrank at step 4 (lanes moved between
    shards), stopped at step 6, resumes on the same mesh bit for bit; the
    file is an unsharded batch's (the mesh-free port resumes it, within
    the module's tolerance) and the JAX package reads its step and
    extra."""
    cs, ss, inits = _black_lanes()
    cfg = Config(**dict(SMALL, iters_num=8, stream_every=2, stop_tol=1e-4,
                        stop_shrink=True, **RUNS[run]))
    path = str(tmp_path / "mesh.npz")

    def batch(mesh=True):
        return pbatch.BatchedTransferJob(
            cs, ss, cfg, params=vgg_params, init_overrides=inits,
            **(dict(mesh=jobs_mesh(devices=CPU2)) if mesh
               else dict(device="cpu")))

    _d, full_imgs, full_losses = _final(batch())
    list(batch().run(iters_num=6, checkpoint_path=path, checkpoint_every=2))
    step, extra = jckpt.peek_checkpoint_meta(path)
    assert step == 6 and extra["lane_orig"] == [2, 3]
    resumed = []
    for mesh in (True, False):  # each from the step-6 file (a resumed
        # run saves at its end)
        shutil.copy(path, path + ".run")
        resumed.append(_final(batch(mesh), checkpoint_path=path + ".run",
                              checkpoint_every=100, resume=True))
    np.testing.assert_array_equal(resumed[0][1], full_imgs)
    np.testing.assert_array_equal(resumed[0][2], full_losses)
    _assert_close([resumed[1]], [(8, full_imgs, full_losses)])


# ---- live serving, warmup, memory -----------------------------------------


def test_live_runner_on_mesh_equals_no_mesh(vgg_params, jobs_data):
    """A joins, then B, C and D join at a boundary: the live batch is
    rebuilt on the mesh with A's state rows transplanted across shards;
    every task ends within the module's tolerance of the same session
    with no mesh."""
    contents, styles = jobs_data
    cfg = Config(**SMALL, iters_num=6, stream_every=2, optimizer="adam")

    def session(mesh):
        r = LiveBatchRunner(cfg, params=vgg_params, mesh=mesh, device="cpu")
        r.submit("A", contents[0], styles[0])
        sizes = [r.step().batch]
        for tid, i in (("B", 1), ("C", 2), ("D", 3)):
            r.submit(tid, contents[i], styles[i])
        finished = {}
        while r.active:
            rep = r.step()
            sizes.append(rep.batch)
            finished.update(rep.finished)
        return finished, sizes

    ours, sizes = session(jobs_mesh(devices=CPU2))
    theirs, plain_sizes = session(None)
    assert sizes[:2] == [2, 4] and plain_sizes[:2] == [1, 4]
    assert sorted(ours) == ["A", "B", "C", "D"]
    _assert_close([(0, ours[t][0], ours[t][1]) for t in sorted(theirs)],
                  [(0, theirs[t][0], theirs[t][1]) for t in sorted(theirs)])


def test_online_executor_on_mesh(vgg_params):
    """The executor's mesh reaches every round (the JAX package's
    test_online_forwards_mesh_to_queue) and the live path serves two
    concurrent tasks on it."""
    mesh = jobs_mesh(devices=CPU2)
    seen = []

    def runner(jobs, cfg, mesh=None, **kw):
        seen.append(mesh)
        return {tid: np.zeros((16, 16, 3), np.float32)
                for tid, _c, _s in jobs}, {}

    rng = np.random.default_rng(0)
    imgs = [rng.random((16, 16, 3)).astype(np.float32) for _ in range(4)]
    from artstyletransfer_tpu_torch.engine.transfer import ContentStylePair

    def pair(i):
        return ContentStylePair(("c", imgs[i]), ("s", imgs[i + 2]))

    async def go(ex, n):
        for i in range(n):
            await ex.add_task(f"t{i}", pair(i))
        await ex.run()
        return {f"t{i}": await ex.get_progress(f"t{i}") for i in range(n)}

    cfg = Config(**SMALL, iters_num=2, stream_every=1, optimizer="adam")
    ex = OnlineBatchingExecutor(cfg, verbose=False, canonicalize=False,
                                queue_runner=runner, mesh=mesh,
                                batch_window_s=0.0, device="cpu")
    asyncio.run(go(ex, 1))
    assert seen == [mesh]
    ex = OnlineBatchingExecutor(cfg, verbose=False, canonicalize=False,
                                params=vgg_params, mesh=mesh,
                                batch_window_s=0.02, device="cpu")
    done = asyncio.run(go(ex, 2))
    assert ex.failures == {}
    for pct, img in done.values():
        assert pct == 100.0 and img.shape == (16, 16, 3)


@pytest.mark.parametrize("case", ["adam", "lbfgs_sequential",
                                  "unit_stop_shrink"])
def test_online_warmup_plan_on_mesh_matches_jax(case):
    """online_warmup_plan on a jobs axis of 2 against the JAX package's on
    jobs_mesh(2): the same sizes, and a sequential policy drops the
    mesh."""
    kw = dict(SMALL, **{
        "adam": dict(optimizer="adam"),
        "lbfgs_sequential": dict(optimizer="lbfgs"),
        "unit_stop_shrink": dict(optimizer="lbfgs", lbfgs_t_init="unit",
                                 stop_tol=0.01, stop_shrink=True)}[case])
    mesh, jmesh = jobs_mesh(devices=CPU2), jjobs_mesh(2)
    for max_batch in (8, 6):
        sizes, got = twarmup.online_warmup_plan(Config(**kw), mesh,
                                                max_batch=max_batch)
        j_sizes, j_got = jwarmup.online_warmup_plan(JConfig(**kw), jmesh,
                                                    max_batch=max_batch)
        assert sizes == j_sizes
        assert (got is mesh) == (j_got is jmesh)
    assert (got is None) == (case == "lbfgs_sequential")


def test_warmup_on_mesh_captures_each_shards_graphs(vgg_params,
                                                    monkeypatch):
    """warmup_aspect_buckets on a mesh builds sharded batches, and a run of
    the same size then captures nothing."""
    from artstyletransfer_tpu_torch.engine import graphs

    monkeypatch.setattr(pbatch, "use_graphs", lambda device, graphs: True)
    cfg = Config(**SMALL, iters_num=1, stream_every=1, optimizer="adam")
    mesh = jobs_mesh(devices=CPU2)
    n = twarmup.warmup_aspect_buckets(cfg, params=vgg_params, aspects=(1.0,),
                                      batch_sizes=(4,), mesh=mesh,
                                      verbose=False, device="cpu")
    assert n == 1  # two shards of 2 lanes on one device: one graph
    before = graphs.CAPTURES
    img = np.full((16, 16, 3), 0.5, np.float32)
    list(pbatch.BatchedTransferJob([img] * 4, [img] * 4, cfg,
                                   params=vgg_params, mesh=mesh).run())
    assert graphs.CAPTURES == before


def test_memory_stats_per_card():
    """5 lanes on a 3-wide jobs mesh: each card holds ceil(5 / 3) = 2
    lanes, and the counts are those of a 2-lane batch on one card."""
    cfg = Config(**SMALL, optimizer="lbfgs", lbfgs_history=3)
    mesh = jobs_mesh(devices=["cpu"] * 3)
    stats = pmemory.memory_stats(cfg, (24, 32), 5, mesh=mesh)
    one = pmemory.memory_stats(cfg, (24, 32), 2, device="cpu")
    assert stats == dict(one, jobs_axis=3, lanes_per_card=2)


# ---- frontends, launch counts, space sharding -----------------------------


def test_queue_cli_mesh_flag(tmp_path, monkeypatch):
    """--mesh none runs on one device; --mesh auto serves on every card
    (the queue gets default_serving_mesh()), and is no mesh with --device
    cpu; --space > 1 exits with its message."""
    from artstyletransfer_tpu_torch import parallel
    from artstyletransfer_tpu_torch.frontends.queue_cli import main
    from artstyletransfer_tpu_torch.utils.image import save_image

    img = str(tmp_path / "a.png")
    save_image(np.full((16, 16, 3), 0.5, np.float32), img)
    seen = []

    def fake_queue(jobs, cfg, mesh=None, device=None, **kw):
        seen.append((mesh, str(device)))
        return {tid: np.zeros((16, 16, 3), np.float32)
                for tid, _c, _s in jobs}, {}

    monkeypatch.setattr(parallel, "run_job_queue", fake_queue)
    base = ["--pair", img, img, "--output-dir", str(tmp_path / "out"),
            "--quiet", "--levels", "1", "--iters", "1",
            "--base-diameter", "16"]
    monkeypatch.setenv("ASTT_SERVING_MESH", "auto")
    assert main(base + ["--device", "cpu"]) == 0
    assert main(base + ["--device", "cpu", "--mesh", "none"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert main(base) == 0
    assert main(base + ["--mesh", "none"]) == 0
    meshes = [m for m, _d in seen]
    assert meshes[:2] == [None, None] and meshes[3] is None
    assert meshes[2].shape == {"jobs": 2, "space": 1}
    with pytest.raises(SystemExit):
        main(base + ["--device", "cpu", "--space", "2"])


def test_launch_counts_per_device_from_two_threads():
    """Threads counting launches on two cards at once (more threads than
    cores, a short switch interval) lose no count, in the totals and per
    card."""
    saved = (dict(kernels.LAUNCHES), kernels.device_launches())
    switch = sys.getswitchinterval()
    kernels.reset_launches()
    n, per_card = 2000, 8

    def count(dev):
        for _ in range(n):
            kernels.launched("gram", 0, dev)
        kernels.add_launches({"tv": n}, dev)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=count, args=(d % 2,))
                   for d in range(2 * per_card)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert kernels.LAUNCHES["gram"] == 2 * per_card * n
        assert kernels.LAUNCHES["tv"] == 2 * per_card * n
        got = kernels.device_launches()
        assert {d: (c["gram"], c["tv"]) for d, c in got.items()} == {
            0: (per_card * n, per_card * n), 1: (per_card * n, per_card * n)}
    finally:
        sys.setswitchinterval(switch)
        kernels.reset_launches()
        kernels.LAUNCHES.update(saved[0])
        kernels.DEVICE_LAUNCHES.update(saved[1])


def test_shard_threads_join_the_callers_precision_gate():
    """Shard threads hold the caller's gate at once, even while a job of
    another precision waits for it (they would wait behind that job,
    which waits for the caller: a deadlock); joining a gate that is not
    held at that precision raises."""
    from artstyletransfer_tpu_torch.config import (held_precision,
                                                   join_precision_gate,
                                                   precision_gate)
    from artstyletransfer_tpu_torch.parallel.shards import run_on_shards

    cpus = [torch.device("cpu")] * 2
    entered, done = threading.Event(), []

    def other_precision():
        with precision_gate("default"):
            entered.set()

    with precision_gate("highest"):
        waiter = threading.Thread(target=other_precision)
        waiter.start()
        time.sleep(0.05)  # the waiter is queued behind the holder
        # the holder's shard threads: they must not queue behind the waiter
        assert run_on_shards(cpus, [held_precision] * 2) == ["highest"] * 2
        assert not entered.is_set()
        done.append(True)
    waiter.join(timeout=30)
    assert not waiter.is_alive() and entered.is_set() and done
    with pytest.raises(RuntimeError, match="not held"):
        with join_precision_gate("highest"):
            pass


def test_resolve_device_names_the_card(eight_cards, monkeypatch):
    """A bare 'cuda' resolves to the current card's index; an index past
    the visible cards raises."""
    from artstyletransfer_tpu_torch.config import resolve_device

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cuda:7") == torch.device("cuda", 7)
    with pytest.raises(ValueError, match="not visible"):
        resolve_device("cuda:8")


def test_shared_params_keep_every_devices_copy(vgg_params):
    """Weights are kept per source with a copy per device: sources on two
    devices each (the cards of a mesh) evict none of their copies, where
    a cache keyed by (source, device) would drop the oldest; captured
    graphs bind these tensors, so each card would capture again."""
    from artstyletransfer_tpu_torch.models import weights

    sources = [dict(vgg_params) for _ in range(3)]
    first = {(i, d): weights.shared_params(src, 0, d)
             for i, src in enumerate(sources) for d in ("cpu", "meta")}
    for (i, d), copy in first.items():
        assert weights.shared_params(sources[i], 0, d) is copy
    assert first[(0, "meta")]["conv1_1"]["w"].device.type == "meta"


def test_space_sharding_still_raises(jobs_data, vgg_params, capsys):
    """Below the space gate (parallel/space.py: the lowest level under
    32 px a block) a jobs x space mesh with shard_space runs unsharded on
    the row's first device and says why on stderr, in the batch, the
    queue and the memory report (they raised before space sharding was
    ported; tests/test_torch_space.py drives it above the gate)."""
    contents, styles = jobs_data
    cfg = Config(**SMALL, iters_num=1)
    mesh = jobs_space_mesh(1, 2, devices=CPU2)
    b = pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                  params=vgg_params, mesh=mesh,
                                  shard_space=True)
    assert b.space is None and b.shards is None
    assert "unsharded" in capsys.readouterr().err
    done, fails = pbatch.run_job_queue([("a", contents[0], styles[0])], cfg,
                                       mesh=mesh, shard_space=True)
    assert list(done) == ["a"] and not fails
    stats = pmemory.memory_stats(cfg, (32, 32), mesh=mesh, shard_space=True)
    assert "per_shard" not in stats
    # without shard_space each jobs row runs on its first device
    b = pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                  params=vgg_params, mesh=mesh)
    assert b.shards is None and b.device == torch.device("cpu")
    assert isinstance(Lanes([torch.zeros(1, 2)]).cpu(), torch.Tensor)
