"""Checkpoint and resume in the port, on the CPU: engine/checkpoint.py, and
TransferJob.run, BatchedTransferJob.run (in the middle of a shrink too),
run_job_queue and the two CLIs through it. Mirrors the JAX package's
tests/test_aux.py:27-189, test_parallel.py:169,204,489,
test_round2_fixes.py:38,65,82, test_round4_fixes.py:476,512,
test_round5_fixes.py:132 and test_engine.py:768.

On one device a resumed run equals the uninterrupted one bit for bit: the
checkpoint holds the whole optimization state (Adam's moments and step;
L-BFGS's history, carried Grams, gradient, loss and counters), and the
CPU's kernels are deterministic. The JAX package reads the port's files
(magic, step, extra and the bfloat16 leaves' bits).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.engine import checkpoint as jckpt
from artstyletransfer_tpu.engine.transfer import (
    lbfgs_history_gb as jax_history_gb,
)
from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import checkpoint as ckpt
from artstyletransfer_tpu_torch.engine.transfer import (
    TransferJob,
    _Lbfgs,
    lbfgs_history_gb,
)
from artstyletransfer_tpu_torch.parallel import batch as pbatch

LBFGS = dict(optimizer="lbfgs", lbfgs_history=4)
CASES = {
    "adam": dict(optimizer="adam"),
    "lbfgs": LBFGS,
    "lbfgs_grams": dict(LBFGS, lbfgs_grams="incremental"),
    "lbfgs_bf16": dict(LBFGS, lbfgs_state_dtype="bfloat16"),
    "lbfgs_grams_bf16": dict(LBFGS, lbfgs_grams="incremental",
                             lbfgs_state_dtype="bfloat16"),
}


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
def images():
    rng = np.random.default_rng(13)
    return (rng.random((40, 48, 3)).astype(np.float32),
            rng.random((32, 32, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def shrink_pair():
    """tests/test_round5_fixes.py's pair."""
    rng = np.random.default_rng(7)
    content = rng.random((48, 64, 3)).astype(np.float32)
    style = rng.random((40, 40, 3)).astype(np.float32)
    content2 = np.random.default_rng(123).random(
        content.shape).astype(np.float32)
    return [content, content2], [style, style]


def _job(images, params, **kw):
    cfg = Config(**{**dict(levels_num=1, iters_num=8, base_diameter=16,
                           stream_every=4), **kw})
    return TransferJob(*images, cfg, params=params, device="cpu")


def _batch(contents, styles, params, **kw):
    cfg = Config(**{**dict(levels_num=1, base_diameter=16), **kw})
    return pbatch.BatchedTransferJob(contents, styles, cfg, params=params,
                                     device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_resume_is_bit_exact(images, vgg_params, tmp_path, case):
    """Half a run with a checkpoint, then a new job resumes it: the same
    image and loss as the uninterrupted run, bit for bit. A checkpoint of
    one state option does not resume the other."""
    kw = CASES[case]
    path = str(tmp_path / "job.npz")
    full = list(_job(images, vgg_params, **kw).run())
    half = list(_job(images, vgg_params, **kw).run(
        iters_num=4, checkpoint_path=path, checkpoint_every=4))
    assert half[-1][0] == 4
    resumed = list(_job(images, vgg_params, **kw).run(
        iters_num=8, checkpoint_path=path, checkpoint_every=100,
        resume=True))
    assert [d for d, _i, _f in resumed] == [8]
    np.testing.assert_array_equal(resumed[-1][1], full[-1][1])
    assert resumed[-1][2] == full[-1][2]
    if case.startswith("lbfgs_"):
        other = dict(kw, lbfgs_grams="recompute",
                     lbfgs_state_dtype="float32")
        with pytest.raises(ValueError, match="different engine config"):
            list(_job(images, vgg_params, **other).run(
                checkpoint_path=path, resume=True))


def test_bf16_leaves_round_trip_and_jax_reads_them(images, vgg_params,
                                                   tmp_path, monkeypatch):
    """An L-BFGS checkpoint with bfloat16 history and carried Grams: the
    loaded leaves equal the saved state bit for bit, and the JAX package's
    peek_checkpoint_meta and _decode_array read the same step, extra and
    bits."""
    path = str(tmp_path / "job.npz")
    saved = {}
    real_save = ckpt.save_checkpoint

    def keep(p, x, opt_state, step, **kw):
        saved.update({k: v.clone() for k, v in opt_state.items()},
                     x=x.clone(), step=step, extra=kw.get("extra"))
        real_save(p, x, opt_state, step, **kw)

    monkeypatch.setattr(ckpt, "save_checkpoint", keep)
    job = _job(images, vgg_params, **CASES["lbfgs_grams_bf16"],
               stop_tol=1e-9)
    list(job.run(iters_num=4, checkpoint_path=path, checkpoint_every=4))
    x, leaves, step, extra = ckpt.load_checkpoint(
        path, _Lbfgs.leaf_specs(job.cfg, 1, saved["x"].numel()),
        with_extra=True)
    assert step == saved["step"] == 4 and extra == saved["extra"]
    assert leaves["s_hist"].dtype == torch.bfloat16
    assert set(leaves) == {"s_hist", "y_hist", "rho", "sy_gram", "yy_gram",
                           "g", "count", "f", "n_evals", "n_iter"}
    assert torch.equal(x, saved["x"])
    for name, leaf in leaves.items():
        assert torch.equal(leaf, saved[name]), name

    j_step, j_extra = jckpt.peek_checkpoint_meta(path)
    assert (j_step, j_extra) == (4, extra)
    with np.load(path) as data:
        ext = json.loads(str(data["ext_dtypes_json"]))
        assert ext == {"opt_s_hist": "bfloat16", "opt_y_hist": "bfloat16"}
        for name in ("s_hist", "y_hist"):
            got = jckpt._decode_array(data[f"opt_{name}"],
                                      ext[f"opt_{name}"])
            assert str(got.dtype) == "bfloat16"
            np.testing.assert_array_equal(
                got.view(np.uint16),
                saved[name].view(torch.int16).numpy().view(np.uint16))


def test_load_rejects_other_configs_shapes_and_leaves(images, vgg_params,
                                                      tmp_path):
    """A changed loss weight or another content shape fails the
    fingerprint; a template of another shape, dtype or set of leaves fails
    with the leaf named; the unchanged config resumes."""
    path = str(tmp_path / "job.npz")
    list(_job(images, vgg_params, optimizer="adam", iters_num=4,
              stream_every=2).run(checkpoint_path=path, checkpoint_every=2))
    base = dict(optimizer="adam", iters_num=4, stream_every=2)
    with pytest.raises(ValueError, match="different engine config"):
        list(_job(images, vgg_params, **base, style_weight=8e5).run(
            checkpoint_path=path, resume=True))
    with pytest.raises(ValueError, match="different engine config"):
        list(_job(images[::-1], vgg_params, **base).run(
            checkpoint_path=path, resume=True))
    n = 16 * 19 * 3
    good = {"mu": torch.empty((1, n)), "nu": torch.empty((1, n)),
            "count": torch.empty((), dtype=torch.int64)}
    ckpt.load_checkpoint(path, good)
    with pytest.raises(ValueError, match="'mu' has shape"):
        ckpt.load_checkpoint(path, dict(good, mu=torch.empty((2, n))))
    with pytest.raises(ValueError, match="'count' has dtype"):
        ckpt.load_checkpoint(path, dict(good, count=torch.empty(())))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(path, {"mu": good["mu"]})
    out = list(_job(images, vgg_params, **base).run(
        checkpoint_path=path, resume=True))
    assert [d for d, _i, _f in out] == [4]


def test_checkpoint_cadence_not_chunk_aligned(images, vgg_params, tmp_path,
                                              monkeypatch):
    """Chunks end at 2, 4, 6; saves every 3 steps fire at 4 (3 steps
    after 0 have passed) and at the end."""
    saves = []
    real_save = ckpt.save_checkpoint
    monkeypatch.setattr(ckpt, "save_checkpoint",
                        lambda p, x, o, step, **kw: (saves.append(step),
                                                     real_save(p, x, o, step,
                                                               **kw)))
    list(_job(images, vgg_params, optimizer="adam", iters_num=6,
              stream_every=2).run(checkpoint_path=str(tmp_path / "c.ckpt"),
                                  checkpoint_every=3))
    assert saves == [4, 6]


def test_resume_from_completed_checkpoint(images, vgg_params, tmp_path):
    """A finished run's checkpoint yields its final image once, for a job
    and for a batch (with each job's loss at it)."""
    path = str(tmp_path / "done.ckpt")
    job = _job(images, vgg_params, optimizer="adam", iters_num=4,
               stream_every=2)
    final = list(job.run(checkpoint_path=path, checkpoint_every=2))[-1]
    resumed = list(job.run(checkpoint_path=path, resume=True))
    assert len(resumed) == 1
    done, img, loss = resumed[0]
    assert done == 4 and np.isfinite(loss)
    np.testing.assert_array_equal(img, final[1])

    path = str(tmp_path / "batch.ckpt")
    content, style = images
    batch = _batch([content, content], [style, style], vgg_params,
                   optimizer="adam", iters_num=2, stream_every=2)
    final = list(batch.run(checkpoint_path=path, checkpoint_every=2))[-1]
    resumed = list(batch.run(checkpoint_path=path, resume=True))
    assert len(resumed) == 1
    done, imgs, losses = resumed[0]
    assert done == 2 and imgs.shape[0] == 2 and np.isfinite(losses).all()
    np.testing.assert_array_equal(imgs, final[1])


@pytest.mark.parametrize("case", ["adam", "lbfgs_grams_bf16"])
def test_batched_resume_is_bit_exact(images, vgg_params, tmp_path, case):
    """A 2-job batch stopped at half its budget resumes to the same images
    and losses; another lr fails the fingerprint."""
    content, style = images
    args = ([content, np.ascontiguousarray(content[::-1])], [style, style],
            vgg_params)
    kw = dict(CASES[case], iters_num=4, stream_every=2)
    path = str(tmp_path / "batch.npz")
    _d, imgs_full, losses_full = list(_batch(*args, **kw).run())[-1]
    list(_batch(*args, **kw).run(iters_num=2, checkpoint_path=path,
                                 checkpoint_every=2))
    _d, imgs, losses = list(_batch(*args, **kw).run(
        checkpoint_path=path, checkpoint_every=100, resume=True))[-1]
    np.testing.assert_array_equal(imgs, imgs_full)
    np.testing.assert_array_equal(losses, losses_full)
    with pytest.raises(ValueError, match="different engine config"):
        list(_batch(*args, **dict(kw, lr_start=20.0)).run(
            checkpoint_path=path, resume=True))


@pytest.mark.parametrize("kw,chunks,shrunk_at", [
    # the JAX package's calibration: job 0 leaves at step 10, job 1
    # converges at 15
    (dict(optimizer="adam", iters_num=30, stream_every=5, stop_tol=1.3),
     [5, 10, 15], 10),
    # relative loss changes per 2 steps: job 1 0.084 at step 8, job 0
    # 0.124 and 0.108 after it, so job 1 leaves at 8 and job 0 runs on
    (dict(CASES["lbfgs_grams_bf16"], lbfgs_t_init="unit", iters_num=12,
          stream_every=2, stop_tol=0.1), [2, 4, 6, 8, 10, 12], 8),
], ids=["adam", "lbfgs_grams_bf16"])
def test_resume_in_the_middle_of_a_shrink(shrink_pair, vgg_params, tmp_path,
                                          kw, chunks, shrunk_at):
    """A checkpoint taken after a convergence shrink holds the live lane
    and the frozen row: a resume continues at the shrunken size and lands
    on the uninterrupted run bit for bit; the finished file then yields
    the final state once."""
    full = list(_batch(*shrink_pair, vgg_params, **kw).run())
    assert [d for d, _i, _l in full] == chunks
    path = str(tmp_path / "shrink.ckpt")
    it = _batch(*shrink_pair, vgg_params, **kw).run(
        checkpoint_path=path, checkpoint_every=kw["stream_every"])
    for done, _imgs, _losses in it:
        if done == shrunk_at:
            break
    it.close()
    step, extra = ckpt.peek_checkpoint_meta(path)
    assert step == shrunk_at and len(extra["lane_orig"]) == 1
    frozen = [orig for orig, _loss in extra["finished"]]
    assert len(frozen) == 1 and extra["lane_orig"] == [1 - frozen[0]]
    resumed = list(_batch(*shrink_pair, vgg_params, **kw).run(
        checkpoint_path=path, checkpoint_every=kw["stream_every"],
        resume=True))
    assert [d for d, _i, _l in resumed] == chunks[chunks.index(shrunk_at)
                                                  + 1:]
    np.testing.assert_array_equal(resumed[-1][1], full[-1][1])
    np.testing.assert_array_equal(resumed[-1][2], full[-1][2])
    again = list(_batch(*shrink_pair, vgg_params, **kw).run(
        checkpoint_path=path, resume=True))
    assert [d for d, _i, _l in again] == [chunks[-1]]
    np.testing.assert_array_equal(again[-1][1], full[-1][1])
    assert again[-1][2][frozen[0]] == full[-1][2][frozen[0]]


def test_stop_tol_latch_survives_resume(shrink_pair, vgg_params, tmp_path):
    """stop_shrink off: job 1 latches at step 8 (relative change 0.084),
    job 0 converges at 12 (0.108 against 0.124 at 10), so the group stops
    at 12 of 16. Interrupted after step 10, the resumed run keeps the
    latch and stops at 12 with the same results; the converged file then
    yields that state once."""
    kw = dict(CASES["lbfgs_grams_bf16"], lbfgs_t_init="unit", iters_num=16,
              stream_every=2, stop_tol=0.115, stop_shrink=False)
    full = list(_batch(*shrink_pair, vgg_params, **kw).run(
        yield_images=False))
    assert full[-1][0] == 12
    path = str(tmp_path / "latch.ckpt")
    it = _batch(*shrink_pair, vgg_params, **kw).run(
        yield_images=False, checkpoint_path=path, checkpoint_every=2)
    for done, _i, _l in it:
        if done == 10:
            break
    it.close()
    assert ckpt.peek_checkpoint_meta(path)[1]["latched"] == [1]
    resumed = list(_batch(*shrink_pair, vgg_params, **kw).run(
        yield_images=False, checkpoint_path=path, checkpoint_every=2,
        resume=True))
    assert [d for d, _i, _l in resumed] == [12]
    np.testing.assert_array_equal(resumed[-1][1], full[-1][1])
    np.testing.assert_array_equal(resumed[-1][2], full[-1][2])
    again = list(_batch(*shrink_pair, vgg_params, **kw).run(
        yield_images=False, checkpoint_path=path, resume=True))
    assert len(again) == 1 and again[0][0] == 12
    np.testing.assert_array_equal(again[0][1], full[-1][1])


def _queue(images):
    content, style = images
    return [("a", content, style),
            ("b", np.ascontiguousarray(content[::-1]), style)]


def test_run_job_queue_checkpoint_resume(images, vgg_params, tmp_path):
    """A queue stopped after 2 of 4 steps leaves one file per group;
    re-running it with resume=True lands on the uninterrupted queue bit for
    bit, and a finished queue returns its images again."""
    jobs, ck = _queue(images), str(tmp_path / "ck")

    def run(iters, **kw):
        cfg = Config(levels_num=1, iters_num=iters, base_diameter=16,
                     optimizer="adam", stream_every=2)
        return pbatch.run_job_queue(jobs, cfg, params=vgg_params,
                                    device="cpu", **kw)

    _partial, failures = run(2, checkpoint_dir=ck)
    assert not failures
    assert len(list((tmp_path / "ck").glob("queue_*.ckpt"))) == 1
    resumed, failures = run(4, checkpoint_dir=ck, resume=True)
    straight, _ = run(4)
    assert not failures
    for tid in ("a", "b"):
        np.testing.assert_array_equal(resumed[tid], straight[tid])
    again, failures = run(4, checkpoint_dir=ck, resume=True)
    assert not failures
    for tid in ("a", "b"):
        np.testing.assert_array_equal(again[tid], straight[tid])


def test_run_job_queue_retry_resumes_from_checkpoint(images, vgg_params,
                                                     tmp_path, monkeypatch):
    """A group that crashes after its first chunk retries from that
    chunk's checkpoint, not from step 0."""
    seen, real = [], pbatch.BatchedTransferJob

    class CrashesOnce(real):
        def run(self, *a, **kw):
            for item in real.run(self, *a, **kw):
                seen.append(item[0])
                yield item
                if len(seen) == 1:
                    raise RuntimeError("worker crashed mid-run")

    monkeypatch.setattr(pbatch, "BatchedTransferJob", CrashesOnce)
    cfg = Config(levels_num=1, iters_num=4, base_diameter=16,
                 optimizer="adam", stream_every=2)
    results, failures = pbatch.run_job_queue(
        _queue(images)[:1], cfg, params=vgg_params, retries=1,
        retry_delay_s=0.0, checkpoint_dir=str(tmp_path), checkpoint_every=2,
        device="cpu")
    assert not failures and "a" in results
    assert seen == [2, 4]


def test_run_job_queue_fresh_run_removes_stale_checkpoint(
        images, vgg_params, tmp_path, monkeypatch):
    """Without resume, a file of an earlier run of the same task ids is
    removed first, so a retry reruns this run from step 0."""
    jobs = _queue(images)[:1]
    cfg = Config(levels_num=1, iters_num=4, base_diameter=16,
                 optimizer="adam", stream_every=2)
    r1, f1 = pbatch.run_job_queue(jobs, cfg, params=vgg_params,
                                  checkpoint_dir=str(tmp_path), device="cpu")
    path = tmp_path / f"queue_{hashlib.sha1(b'a').hexdigest()[:16]}.ckpt"
    assert not f1 and path.exists()
    calls, real = {"fail": 0, "resumed_from": []}, pbatch.BatchedTransferJob

    class FlakyOnce(real):
        def run(self, *a, **kw):
            if calls["fail"] == 0:
                calls["fail"] += 1
                raise RuntimeError("worker crashed before its first save")
            calls["resumed_from"].append(path.exists())
            return real.run(self, *a, **kw)

    monkeypatch.setattr(pbatch, "BatchedTransferJob", FlakyOnce)
    r2, f2 = pbatch.run_job_queue(jobs, cfg, params=vgg_params, retries=1,
                                  retry_delay_s=0.0,
                                  checkpoint_dir=str(tmp_path), device="cpu")
    assert not f2 and calls == {"fail": 1, "resumed_from": [False]}
    np.testing.assert_array_equal(r1["a"], r2["a"])


def test_history_estimate_matches_jax():
    """bfloat16 history halves the estimate, as in the JAX package."""
    shapes = [(1, 512, 512, 3)]
    for dtype in ("float32", "bfloat16"):
        for batch in (1, 8):
            kw = dict(lbfgs_history=100, lbfgs_state_dtype=dtype)
            assert lbfgs_history_gb(Config(**kw), shapes, batch) == \
                jax_history_gb(JConfig(**kw), shapes, batch)
    assert lbfgs_history_gb(Config(), shapes) == 2 * lbfgs_history_gb(
        Config(lbfgs_state_dtype="bfloat16"), shapes)


def test_clis_checkpoint_and_resume(tmp_path):
    """cli --checkpoint/--resume and queue_cli --checkpoint-dir/--resume
    on the CPU: a second, resumed run of a finished job or queue writes the
    same image."""
    cv2 = pytest.importorskip("cv2")
    from artstyletransfer_tpu_torch.frontends import cli, queue_cli

    rng = np.random.default_rng(1)
    for name in ("c.png", "s.png"):
        cv2.imwrite(str(tmp_path / name),
                    (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    common = ["--device", "cpu", "--levels", "1", "--iters", "2",
              "--base-diameter", "16", "--optimizer", "lbfgs",
              "--lbfgs-history", "3", "--lbfgs-grams", "incremental",
              "--lbfgs-state-dtype", "bfloat16", "--quiet"]
    job = ["--content", str(tmp_path / "c.png"), "--style",
           str(tmp_path / "s.png"), "--checkpoint", str(tmp_path / "j.ckpt"),
           *common]
    assert cli.main([*job, "--output", str(tmp_path / "a.jpg")]) == 0
    assert ckpt.peek_checkpoint_meta(str(tmp_path / "j.ckpt"))[0] == 2
    assert cli.main([*job, "--resume", "--output",
                     str(tmp_path / "b.jpg")]) == 0
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.jpg")),
                                  cv2.imread(str(tmp_path / "b.jpg")))
    args = cli.build_parser().parse_args(job + ["--output", "o.jpg"])
    cfg = cli.config_from_args(args)
    assert (cfg.lbfgs_grams, cfg.lbfgs_state_dtype) == ("incremental",
                                                        "bfloat16")

    queue = ["--pair", str(tmp_path / "c.png"), str(tmp_path / "s.png"),
             "--checkpoint-dir", str(tmp_path / "qck"), *common]
    assert queue_cli.main([*queue, "--output-dir", str(tmp_path / "q1")]) == 0
    assert len(list((tmp_path / "qck").glob("queue_*.ckpt"))) == 1
    assert queue_cli.main([*queue, "--resume", "--output-dir",
                           str(tmp_path / "q2")]) == 0
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "q1/c__s.jpg")),
                                  cv2.imread(str(tmp_path / "q2/c__s.jpg")))
