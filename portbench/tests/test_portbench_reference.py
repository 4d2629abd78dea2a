"""The plain reference, frozen at a tiny size, tied to the port's plain
CPU path, and kept clear of JAX and of the program it judges."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import images, model, optim

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "artstyletransfer_tpu"}
PORT = "artstyletransfer_tpu_torch"


def tiny():
    rng = np.random.default_rng(7)
    hwio, cin = {}, 3
    for name, cout in [l for l in model.LAYERS if l[0] != "pool"]:
        hwio[name] = {"w": (rng.standard_normal((3, 3, cin, cout))
                            * np.sqrt(2 / (9 * cin))).astype(np.float32),
                      "b": np.zeros(cout, np.float32)}
        cin = cout
    with open(os.path.join(BENCH, "configs", "vgg19-2l512-lbfgs.json")) as fh:
        fields = json.load(fh)["fields"]
    fields.update(base_diameter=16)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32
    content = np.stack([0.5 + 0.4 * np.sin(6 * xx + k) * np.cos(5 * yy)
                        for k in range(3)], -1).astype(np.float32)
    style = np.stack([0.5 + 0.5 * np.sin(20 * (xx[:16, :16] + yy[:16, :16]))]
                     * 3, -1).astype(np.float32)
    return hwio, fields, content, style


@pytest.fixture(scope="module")
def job():
    torch.set_num_threads(1)
    hwio, fields, content, style = tiny()
    obj = model.Objective(content, style, fields,
                          model.weights_from_hwio(hwio, "cpu"), "cpu")
    init = images.init_image(content, style, fields, 0)
    x0 = torch.from_numpy(images.prepare(init).reshape(1, -1))
    return hwio, fields, content, style, obj, init, x0


def test_reference_as_frozen(job):
    _h, fields, _c, _s, obj, init, x0 = job
    assert float(init.sum()) == pytest.approx(1580.9298095703125, rel=1e-5)
    assert float(obj.loss(x0)[0]) == pytest.approx(1434514048.0, rel=1e-5)
    levels = [float(v[0]) for v in obj.level_losses(x0)]
    assert levels == pytest.approx([817955136.0, 616558912.0], rel=1e-5)


@pytest.mark.parametrize("opt,f_chunk,evals,x_sum", [
    ("adam", 1074503552.0, 3, 79750.984375),
    ("lbfgs", 301435232.0, 16, 49154.5390625)])
def test_retrace_as_frozen(job, opt, f_chunk, evals, x_sum):
    _h, fields, _c, _s, obj, _i, x0 = job
    r = optim.retrace(obj, x0, dict(fields, optimizer=opt), 3)
    assert r["evals"] == evals
    assert r["f_chunk"] == pytest.approx(f_chunk, rel=1e-4)
    assert float(r["x"].sum()) == pytest.approx(x_sum, rel=1e-4)


def test_reference_meets_the_ports_plain_path(job):
    """The port's CPU path (plain versions of its kernels) builds the same
    initial image and loss as the reference from the same inputs."""
    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob

    hwio, fields, content, style, obj, init, x0 = job
    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()})
    port = TransferJob(content, style, cfg, params=hwio, device="cpu")
    assert np.abs(port._x0.numpy() - x0.numpy()).max() < 1e-3
    assert port.initial_loss() == pytest.approx(float(obj.loss(x0)[0]),
                                                rel=1e-5)


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def bench_modules():
    for base, _dirs, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_jax_anywhere_and_no_program_in_the_reference():
    """Every module of the benchmark, by whole top-level names: none is
    JAX's or the JAX package's (the port's name begins with the latter's,
    so it must not match), and the reference imports nothing of the
    port."""
    seen = set()
    for path in bench_modules():
        tops = set(_imports(path))
        seen |= tops
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert PORT not in tops, path
    assert PORT in seen  # the harness drives the port


@pytest.mark.parametrize("name,bad", [
    ("jax.numpy", True), ("jaxlib", True), ("artstyletransfer_tpu.ops", True),
    ("artstyletransfer_tpu_torch.ops", False), ("jaxtyping", False)])
def test_forbidden_names_are_whole(name, bad):
    import sys

    from portbench import run

    saved = dict(sys.modules)
    try:
        for k in [k for k in sys.modules if k.split(".")[0] in FORBIDDEN]:
            del sys.modules[k]
        sys.modules[name] = object()
        assert bool(run.forbidden_modules()) is bad
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
