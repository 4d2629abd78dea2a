"""Boundaries of the PyTorch/CUDA port: it stands alone, it never falls
back to the CPU quietly, and its config, executor and CLI mirror the JAX
package's."""

import asyncio
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import artstyletransfer_tpu.config as jax_config
from artstyletransfer_tpu_torch import config as port_config
from artstyletransfer_tpu_torch.engine.transfer import (
    ContentStylePair,
    TransferJob,
    neural_style_transfer,
)
from artstyletransfer_tpu_torch.runtime.executor import Executor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "artstyletransfer_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|optax)\b|from\s+(jax|optax)\b"
    r"|import\s+artstyletransfer_tpu\b(?!_torch)"
    r"|from\s+artstyletransfer_tpu\b(?!_torch))"
    r"|artstyletransfer_tpu\.", re.M)


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(PORT):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    """No `import jax`/`optax` and no `artstyletransfer_tpu.` (a module
    path into the JAX package) in the package or chip_smoke.py. File
    paths such as artstyletransfer_tpu/ops/pallas_kernels.py, which the
    kernels' notes cite, are not imports."""
    files = _port_sources()
    assert len(files) > 15
    for module in ("parallel/batch.py", "frontends/queue_cli.py",
                   "kernels/conv_relu.py", "ops/conv_relu.py",
                   "engine/checkpoint.py", "parallel/live.py",
                   "runtime/online.py", "frontends/lab.py",
                   "frontends/tlbot.py", "models/weights.py"):
        assert os.path.join(PORT, module) in files, module
    offenders = []
    for path in files:
        with open(path) as fh:
            for m in _FORBIDDEN.finditer(fh.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: {m.group(0)!r}")
    assert not offenders, offenders


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((16, 16, 3), np.float32)
    cfg = port_config.Config(levels_num=1, base_diameter=16, iters_num=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransferJob(img, img, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Executor(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_config.resolve_device()

    async def drain():
        pair = ContentStylePair(("c", img), ("s", img))
        async for _ in neural_style_transfer(pair, *([None] * 13),
                                             config=cfg):
            pass

    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(drain())
    from artstyletransfer_tpu_torch.frontends.cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--content", "a.jpg", "--style", "b.jpg", "--output", "c.jpg",
              "--quiet"])
    # the CPU, asked for, is fine
    assert port_config.resolve_device("cpu").type == "cpu"
    Executor(cfg, device="cpu")


def test_config_matches_jax_package():
    ours = {f.name: f.default for f in dataclasses.fields(port_config.Config)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.Config)}
    assert ours == ref
    assert set(port_config.PRESETS) == set(jax_config.PRESETS)
    for name, cfg in port_config.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_config.PRESETS[name]), name
    for cfg_args in (dict(optimizer="adam"),
                     dict(optimizer="lbfgs", lbfgs_max_ls_steps=0)):
        assert (port_config.reference_equivalent_steps(
            port_config.Config(**cfg_args), 500)
            == jax_config.reference_equivalent_steps(
                jax_config.Config(**cfg_args), 500))
    cfg = port_config.Config(compute_dtype="float32")
    assert port_config.production_config(cfg) is cfg


def test_apply_precision_maps_tf32():
    """The precision gate's mapping: inside it cuDNN's TF32 switch follows
    conv_precision ('highest' off, 'default' and 'high' on), the matmul
    switch is never touched, and on leaving the gate the cuDNN switch gets
    back its value from before; an unknown precision raises."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        for before in (True, False):
            for matmul in (True, False):
                torch.backends.cudnn.allow_tf32 = before
                torch.backends.cuda.matmul.allow_tf32 = matmul
                for precision, tf32 in (("highest", False), ("default", True),
                                        ("high", True)):
                    with port_config.precision_gate(precision):
                        assert torch.backends.cudnn.allow_tf32 is tf32
                        assert torch.backends.cuda.matmul.allow_tf32 is matmul
                    assert torch.backends.cudnn.allow_tf32 is before
        with pytest.raises(ValueError):
            with port_config.precision_gate("x"):
                pass
        with port_config.precision_gate("highest"):
            with port_config.precision_gate("highest"):  # re-entry: no wait
                assert not torch.backends.cudnn.allow_tf32
            with pytest.raises(RuntimeError):
                with port_config.precision_gate("default"):
                    pass
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_executor_runs_a_cpu_job_to_completion():
    """The reference executor flow through the real engine on the CPU:
    progress reaches 100% with an image, and no failure is recorded."""
    rng = np.random.default_rng(0)
    content = rng.random((18, 20, 3)).astype(np.float32)
    style = rng.random((16, 16, 3)).astype(np.float32)
    cfg = port_config.Config(levels_num=1, base_diameter=16, iters_num=3,
                             stream_every=2, optimizer="adam")
    seen = []

    async def report(task_id, result):
        seen.append(result[0])

    async def go():
        ex = Executor(cfg, report_progress=report, verbose=False,
                      device="cpu")
        await ex.add_task("t1", ContentStylePair(("c", content),
                                                 ("s", style)))
        await ex.run()
        return ex, await ex.get_progress("t1")

    ex, (percent, img) = asyncio.run(go())
    assert not ex.failures
    assert percent == 100.0 and img.shape == (16, 17, 3)
    assert seen[-1] == 100.0 and len(seen) == 2


def test_cli_cpu_run_writes_output(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(1)
    for name in ("c.png", "s.png"):
        cv2.imwrite(str(tmp_path / name),
                    (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    from artstyletransfer_tpu_torch.frontends.cli import main

    out = tmp_path / "out.jpg"
    rc = main(["--content", str(tmp_path / "c.png"),
               "--style", str(tmp_path / "s.png"), "--output", str(out),
               "--device", "cpu", "--levels", "1", "--iters", "2",
               "--base-diameter", "16", "--optimizer", "adam", "--quiet",
               "--metrics", str(tmp_path / "m.jsonl")])
    assert rc == 0 and out.exists()
    assert cv2.imread(str(out)).shape == (16, 19, 3)
