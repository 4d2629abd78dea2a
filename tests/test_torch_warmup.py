"""The port's engine/warmup.py against the JAX package's, on the CPU.

The plans and the warmed (bucket shape, batch size) sets must equal the
JAX package's exactly (pure host arithmetic). The port's own warmup then
runs for real through the graphs' static-buffer plumbing (graphs forced
on, the body called eagerly at each replay): every (bucket, size) is
captured once, and a queue round over the warmed buckets captures
nothing.
"""

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine import transfer as jtransfer
from artstyletransfer_tpu.engine import warmup as jwarmup
from artstyletransfer_tpu.parallel import batch as jbatch
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import graphs
from artstyletransfer_tpu_torch.engine import transfer as ttransfer
from artstyletransfer_tpu_torch.engine import warmup as twarmup
from artstyletransfer_tpu_torch.parallel import batch as pbatch

SMALL = dict(levels_num=1, base_diameter=16)
PLANS = {
    "adam": dict(optimizer="adam"),
    "lbfgs_sequential": dict(optimizer="lbfgs"),
    "lbfgs_unit": dict(optimizer="lbfgs", lbfgs_t_init="unit"),
    "lbfgs_ref": dict(optimizer="lbfgs", lbfgs_max_ls_steps=0),
    "adam_stop_shrink": dict(optimizer="adam", stop_tol=0.01,
                             stop_shrink=True),
    "unit_stop_shrink": dict(optimizer="lbfgs", lbfgs_t_init="unit",
                             stop_tol=0.01, stop_shrink=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("max_batch", [8, 4, 6])
@pytest.mark.parametrize("case", list(PLANS))
def test_online_warmup_plan_matches_jax(case, max_batch):
    """(d) The (sizes, mesh) plan of every routing the JAX package's test
    covers (tests/test_round4_fixes.py), without a mesh."""
    kw = dict(SMALL, **PLANS[case])
    ours = twarmup.online_warmup_plan(Config(**kw), None,
                                      max_batch=max_batch)
    theirs = jwarmup.online_warmup_plan(JConfig(**kw), None,
                                        max_batch=max_batch)
    assert ours == theirs
    if case == "adam" and max_batch == 8:
        assert ours == ((1, 2, 4, 8), None)


def test_online_warmup_plan_one_card():
    with pytest.raises(NotImplementedError, match="mesh"):
        twarmup.online_warmup_plan(Config(**SMALL), object())
    with pytest.raises(NotImplementedError, match="mesh"):
        twarmup.warmup_aspect_buckets(Config(**SMALL), mesh=object())


def _spy(calls):
    """A job class that records (content shape, batch size or None) and
    runs nothing."""

    class Spy:
        def __init__(self, contents, styles, cfg, params=None, **kw):
            if isinstance(contents, np.ndarray):
                calls.append((contents.shape, None))
            else:
                calls.append((contents[0].shape, len(contents)))

        def run(self, **kw):
            return iter(())

        def warm_shrink_gathers(self):
            return 0

        def warm_live_chunk(self, n_steps):
            return 0

        def warm_shrink_graphs(self):
            return 0

    return Spy


@pytest.mark.parametrize("batch_sizes", [None, (1, 2)])
def test_warmup_aspect_buckets_warms_what_jax_warms(monkeypatch,
                                                    batch_sizes):
    """(e) The same (bucket shape, size) jobs in the same order as the
    JAX package's warmup (tests/test_parallel.py's aspects and sizes),
    from spies on both packages' job constructors."""
    ours, theirs = [], []
    monkeypatch.setattr(jtransfer, "TransferJob", _spy(theirs))
    monkeypatch.setattr(jbatch, "BatchedTransferJob", _spy(theirs))
    monkeypatch.setattr(twarmup, "TransferJob", _spy(ours))
    monkeypatch.setattr(twarmup, "BatchedTransferJob", _spy(ours))
    kw = dict(SMALL, optimizer="adam", iters_num=2, stream_every=2)
    jwarmup.warmup_aspect_buckets(JConfig(**kw), params={},
                                  aspects=(1.0, 1.5), verbose=False,
                                  batch_sizes=batch_sizes)
    twarmup.warmup_aspect_buckets(Config(**kw), params={},
                                  aspects=(1.0, 1.5), verbose=False,
                                  batch_sizes=batch_sizes)
    assert ours == theirs
    sizes = batch_sizes or (None,)
    assert ours == [((16, w, 3), s) for w in (16, 24) for s in sizes]


def test_warmup_serving_shared_entry(monkeypatch):
    """warmup_serving: single-job graphs without online batching, the
    online plan's sizes with it (the JAX package's test)."""
    calls = {}

    def fake_buckets(c, params=None, aspects=None, batch_sizes=None,
                     mesh=None, **kw):
        calls.update(sizes=batch_sizes, mesh=mesh, aspects=aspects)
        return 1

    monkeypatch.setattr(twarmup, "warmup_aspect_buckets", fake_buckets)
    cfg = Config(**SMALL, optimizer="adam")
    assert twarmup.warmup_serving(cfg, online=False) == 1
    assert calls == {"sizes": None, "mesh": None, "aspects": None}
    assert twarmup.warmup_serving(cfg, online=True, aspects=(1.0,)) == 1
    assert calls == {"sizes": (1, 2, 4, 8), "mesh": None, "aspects": (1.0,)}


@pytest.fixture
def graphed(monkeypatch):
    """Graphs on for CPU jobs (the eager-replay seam), from an empty
    cache."""
    for mod in (ttransfer, pbatch):
        monkeypatch.setattr(mod, "use_graphs", lambda device, graphs: True)
    ttransfer._COMPILE_CACHE.clear()
    yield
    ttransfer._COMPILE_CACHE.clear()


def test_warmup_captures_each_bucket_once_then_the_queue_nothing(
        vgg_params, graphed):
    """Every (bucket, size) is captured once; a second warmup and a
    padded queue round over the warmed buckets capture nothing."""
    cfg = Config(**SMALL, optimizer="adam", iters_num=2, stream_every=1)
    warm = dict(params=vgg_params, aspects=(1.0, 1.5), verbose=False,
                steps=1, batch_sizes=(1, 2), device="cpu")
    assert twarmup.warmup_aspect_buckets(cfg, **warm) == 4
    assert len(ttransfer._COMPILE_CACHE) == 4
    assert twarmup.warmup_aspect_buckets(cfg, **warm) == 0
    rng = np.random.default_rng(2)
    jobs = [(f"j{i}", rng.random(hw + (3,)).astype(np.float32),
             rng.random((20, 20, 3)).astype(np.float32))
            for i, hw in enumerate([(30, 30), (32, 31), (20, 30)])]
    before = graphs.CAPTURES
    results, failures = pbatch.run_job_queue(
        jobs, cfg, params=vgg_params, canonicalize_contents=True,
        canonicalize_styles=True, pad_batches=True, device="cpu")
    assert not failures
    assert graphs.CAPTURES == before
    assert {r.shape for r in results.values()} == {(16, 16, 3), (16, 24, 3)}


def test_warm_shrink_graphs_captures_the_ladder(vgg_params, graphed):
    """A 4-lane batch with stop_shrink captures its 4-lane graph in its
    run and the shrink ladder's 1 and 2 in warm_shrink_graphs; without
    stop_shrink it captures nothing more."""
    img = np.random.default_rng(3).random((16, 16, 3)).astype(np.float32)
    cfg = Config(**SMALL, optimizer="adam", stop_tol=0.01, stop_shrink=True)
    assert twarmup.warmup_aspect_buckets(
        cfg, params=vgg_params, aspects=(1.0,), verbose=False, steps=1,
        batch_sizes=(4,), device="cpu") == 3
    job = pbatch.BatchedTransferJob([img] * 4, [img] * 4, cfg,
                                    params=vgg_params, device="cpu")
    assert job.warm_shrink_graphs() == 0  # all cached
    plain = Config(**SMALL, optimizer="adam")
    job = pbatch.BatchedTransferJob([img] * 4, [img] * 4, plain,
                                    params=vgg_params, device="cpu")
    assert job.warm_shrink_graphs() == 0


def test_warmup_serving_warms_on_the_device_it_is_given(monkeypatch, graphed,
                                                        tmp_path):
    """warmup_serving(..., device='cpu') captures every online size on the
    CPU, with no card visible (a frontend's --warmup --device cpu)."""
    from artstyletransfer_tpu_torch.models import weights as tweights

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("ASTT_VGG19_WEIGHTS", raising=False)
    monkeypatch.setattr(tweights, "_CACHE_FILE", str(tmp_path / "none.npz"))
    cfg = Config(**SMALL, optimizer="adam", iters_num=1, stream_every=1)
    assert twarmup.warmup_serving(cfg, online=True, aspects=(1.0,),
                                  device="cpu") == 4
    keys = list(ttransfer._COMPILE_CACHE._d)
    assert sorted(k[-3] for k in keys) == [1, 2, 4, 8]
    assert {k[-2] for k in keys} == {"cpu"}
