"""Per-job float32 precision in the port, under concurrent jobs (CPU).

torch.backends.cudnn.allow_tf32 is one switch for the whole process, and
the executor runs jobs in several threads. A job holds
config.precision_gate around each unit of its device work, so its convs
run at its own conv_precision whatever the other jobs' is; the port never
sets the matmul switch, so the L-BFGS history contractions and the
pyramid resize run in full float32 at every precision (the JAX package
runs the contractions at Precision.HIGHEST). The threads meet at events
and barriers with timeouts, so no test can hang.
"""

import sys
import threading

import numpy as np
import torch
import torch.nn.functional as F

from artstyletransfer_tpu_torch.config import Config, precision_gate
from artstyletransfer_tpu_torch.engine import lbfgs
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.models import vgg19
from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

_WAIT_S = 2.0


def _lane_state(rng, lanes=2, m=4, n=64):
    s = rng.standard_normal((lanes, m, n)).astype(np.float32)
    y = s + 0.1 * rng.standard_normal((lanes, m, n)).astype(np.float32)
    rho = 1.0 / np.einsum("bmn,bmn->bm", s, y)
    g = torch.from_numpy(rng.standard_normal((lanes, n)).astype(np.float32))
    state = lbfgs.LaneLbfgsState(
        s_hist=torch.from_numpy(s), y_hist=torch.from_numpy(y),
        rho=torch.from_numpy(rho.astype(np.float32)),
        count=np.array([m, m - 1], np.int64),
        f=np.zeros((lanes,), np.float32), g=g,
        n_evals=np.ones((lanes,), np.int64), n_iter=1)
    return g, state


def test_history_contractions_never_run_in_tf32(monkeypatch, rng):
    """Two threads compute the lane two-loop direction; the first sits
    inside a 'default' job (TF32 convs). The second starts its contractions
    while the first is inside its own and resumes once the first is done:
    the order in which a save-and-restore of the matmul switch hands one
    thread's TF32 to the other. Every torch.bmm must see the switch off."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    seen = []
    first_in, second_in, first_done = (threading.Event() for _ in range(3))
    bmm = torch.bmm

    def recording_bmm(*args, **kwargs):
        name = threading.current_thread().name
        seen.append((name, torch.backends.cuda.matmul.allow_tf32))
        if name == "in_job" and not first_in.is_set():
            first_in.set()
            second_in.wait(_WAIT_S)
        elif name == "bare" and not second_in.is_set():
            second_in.set()
            first_done.wait(_WAIT_S)
        return bmm(*args, **kwargs)

    monkeypatch.setattr(torch, "bmm", recording_bmm)
    g, state = _lane_state(rng)
    expected = lbfgs._lane_two_loop_direction(g, state)
    seen.clear()
    out, errors = {}, []

    def in_job():
        try:
            with precision_gate("default"):
                out["in_job"] = lbfgs._lane_two_loop_direction(g, state)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
        finally:
            first_done.set()

    def bare():
        try:
            first_in.wait(_WAIT_S)
            out["bare"] = lbfgs._lane_two_loop_direction(g, state)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=in_job, name="in_job"),
               threading.Thread(target=bare, name="bare")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert {name for name, _ in seen} == {"in_job", "bare"}
    assert [tf32 for _, tf32 in seen] == [False] * len(seen), seen
    for name in ("in_job", "bare"):
        torch.testing.assert_close(out[name], expected)


class _RecordingF:
    """torch.nn.functional as models/vgg19.py sees it, with conv2d
    recording cuDNN's TF32 switch per thread. Each thread's first conv
    waits (up to _WAIT_S) for the other thread's first conv, so that both
    jobs have started before either reads the switch."""

    def __init__(self):
        self.seen = {"highest": [], "default": []}
        self._meet = threading.Barrier(2, timeout=_WAIT_S)
        self._met = set()

    def __getattr__(self, name):
        return getattr(F, name)

    def conv2d(self, *args, **kwargs):
        name = threading.current_thread().name
        if name not in self._met:
            self._met.add(name)
            try:
                self._meet.wait()
            except threading.BrokenBarrierError:
                pass  # the other job waits for the gate: expected
        self.seen[name].append(torch.backends.cudnn.allow_tf32)
        return F.conv2d(*args, **kwargs)


def test_jobs_of_two_precisions_keep_their_own_conv_tf32(monkeypatch):
    """A 'highest' job and a 'default' job, each from its construction
    through every chunk of its run, in two threads at once: every conv of
    the 'highest' job runs with cuDNN's TF32 off and every conv of the
    'default' job with it on."""
    recording = _RecordingF()
    monkeypatch.setattr(vgg19, "F", recording)
    rng = np.random.default_rng(0)
    content = rng.random((16, 16, 3)).astype(np.float32)
    style = rng.random((16, 16, 3)).astype(np.float32)
    params = init_vgg19_params(seed=0)
    done, errors = [], []

    def job(precision):
        try:
            cfg = Config(levels_num=1, base_diameter=16, iters_num=3,
                         stream_every=1, optimizer="adam",
                         conv_precision=precision)
            job = TransferJob(content, style, cfg, params=params,
                              device="cpu")
            steps = [d for d, _img, _loss in job.run()]
            done.append((precision, steps))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=job, args=(p,), name=p)
               for p in ("highest", "default")]
    saved = torch.backends.cudnn.allow_tf32
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(done) == [("default", [1, 2, 3]), ("highest", [1, 2, 3])]
    assert recording.seen["highest"] and recording.seen["default"]
    assert not any(recording.seen["highest"]), recording.seen
    assert all(recording.seen["default"]), recording.seen
    assert torch.backends.cudnn.allow_tf32 is saved


def test_resize_runs_in_float32_at_default_precision(monkeypatch):
    """The pyramid's bicubic downscale (two einsums per level) inside a
    'default' job sees the matmul switch off: full float32 at every
    conv_precision, where the JAX package runs it at the job's precision
    (a deliberate divergence, ROADMAP Queue 3)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    seen = []
    einsum = torch.einsum

    def recording_einsum(*args, **kwargs):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return einsum(*args, **kwargs)

    monkeypatch.setattr(torch, "einsum", recording_einsum)
    rng = np.random.default_rng(1)
    img = rng.random((32, 32, 3)).astype(np.float32)
    cfg = Config(levels_num=2, base_diameter=16, iters_num=1,
                 optimizer="adam", conv_precision="default")
    job = TransferJob(img, img, cfg, params=init_vgg19_params(seed=0),
                      device="cpu")
    list(job.run())
    assert seen and not any(seen)


def test_gate_never_mixes_precisions_under_contention():
    """Stress: 12 threads, a short switch interval, each entering the gate
    40 times with a random precision (some re-entering). Inside, the
    holders' precisions never mix and cuDNN's switch always has theirs;
    afterwards it has its value from before."""
    holders = {"default": 0, "high": 0, "highest": 0}
    lock = threading.Lock()
    bad, errors = [], []
    tf32 = {"default": True, "high": True, "highest": False}

    def worker(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(40):
                p = str(rng.choice(list(tf32)))
                with precision_gate(p):
                    with lock:
                        holders[p] += 1
                        if any(n for q, n in holders.items() if q != p):
                            bad.append(dict(holders))
                    if torch.backends.cudnn.allow_tf32 is not tf32[p]:
                        bad.append(p)
                    if rng.random() < 0.3:
                        with precision_gate(p):  # re-entry: no wait
                            pass
                    with lock:
                        holders[p] -= 1
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    saved = torch.backends.cudnn.allow_tf32
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not bad, (errors, bad[:5])
    assert torch.backends.cudnn.allow_tf32 is saved
