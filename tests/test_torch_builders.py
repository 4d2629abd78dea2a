"""The port's reference-API builders (engine/builders.py), its CLI flags
for remat and lookahead, and its lazy top-level exports, on the CPU.

The builders against the JAX package's RepresentationBuilder and
LossBuilder on the same seeded weights and image (tests/test_aux.py:
226-260 holds the JAX ones against the JAX engine): losses within rtol
1e-5, feature taps and Grams within 1e-5 of their largest entry.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artstyletransfer_tpu.engine.builders import (
    LossBuilder as JLossBuilder,
    RepresentationBuilder as JRepresentationBuilder,
)
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine.builders import (
    LossBuilder,
    RepresentationBuilder,
)
from artstyletransfer_tpu_torch.engine.pyramid import build_input_pyramids
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.frontends import cli, queue_cli
from artstyletransfer_tpu_torch.models.vgg19 import (
    CONTENT_INDEX,
    STYLE_INDICES,
)
from artstyletransfer_tpu_torch.models.weights import params_from_jax
from artstyletransfer_tpu_torch.parallel.batch import BatchedTransferJob
from artstyletransfer_tpu_torch.utils.image import prepare_img


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    return (rng.random((32, 48, 3)).astype(np.float32),
            rng.random((24, 24, 3)).astype(np.float32))


@pytest.fixture(scope="module")
def level0(images):
    """Level-0 content and style images of a 1-level, 16 px job, and a
    probe image: preprocessed (1, h, w, 3) numpy arrays."""
    content, style = images
    c_lvls, s_lvls = build_input_pyramids(content, style, 1, 16)
    probe = c_lvls[0] * 0.7 + 0.1
    return (prepare_img(c_lvls[0]), prepare_img(s_lvls[0]),
            prepare_img(probe), probe)


@pytest.fixture(scope="module")
def torch_params(vgg_params):
    return params_from_jax(vgg_params, "cpu")


def _close(ours, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def test_representation_builder_matches_jax(level0, vgg_params,
                                            torch_params):
    c, _s, _p, _ = level0
    rb = RepresentationBuilder(torch.from_numpy(c), torch_params)
    jrb = JRepresentationBuilder(jnp.asarray(c), vgg_params)
    _close(rb.build_content(CONTENT_INDEX), jrb.build_content(CONTENT_INDEX))
    multi = rb.build_content([CONTENT_INDEX])
    assert isinstance(multi, list) and len(multi) == 1
    assert torch.equal(multi[0], rb.build_content(CONTENT_INDEX))
    grams = rb.build_style(list(STYLE_INDICES))
    j_grams = jrb.build_style(list(STYLE_INDICES))
    assert len(grams) == len(j_grams) == 5
    for ours, ref in zip(grams, j_grams):
        _close(ours, ref)
    _close(rb.build_style(0), jrb.build_style(0))


def test_loss_builder_matches_jax_and_engine(level0, vgg_params,
                                            torch_params, images):
    c, s, p, probe = level0
    cfg = Config(levels_num=1, base_diameter=16)
    weights = (cfg.content_weight, cfg.style_weight, cfg.tv_weight)
    lb = LossBuilder(CONTENT_INDEX, list(STYLE_INDICES), torch.from_numpy(c),
                     torch.from_numpy(s), torch_params, *weights)
    jlb = JLossBuilder(CONTENT_INDEX, list(STYLE_INDICES), jnp.asarray(c),
                       jnp.asarray(s), vgg_params, *weights)
    ours = lb.build(torch.from_numpy(p))
    ref = jlb.build(jnp.asarray(p))
    for o, r in zip(ours, ref):
        assert o.dim() == 0
        np.testing.assert_allclose(float(o), float(r), rtol=1e-5)
    # the one-level engine loss at the same image (tests/test_aux.py:226)
    content, style = images
    job = TransferJob(content, style, cfg, params=vgg_params, device="cpu")
    total, ((lt, lc, ls, ltv),) = job.loss_report(probe)
    for o, r in zip(ours, (total, lc, ls, ltv)):
        np.testing.assert_allclose(float(o), r, rtol=1e-5)


def test_loss_builder_gradient_flows(level0, torch_params):
    c, s, p, _ = level0
    lb = LossBuilder(CONTENT_INDEX, list(STYLE_INDICES), torch.from_numpy(c),
                     torch.from_numpy(s), torch_params, 1e3, 4e5, 1e2)
    x = torch.from_numpy(p).requires_grad_(True)
    lb.build(x)[0].backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().sum() > 0


def test_loss_builder_noise(level0, torch_params):
    """noise_power > 0: the content target gets noise_power * clamp(0.5 n
    + 0.5, 0, 1), n standard normal from the generator: in [0,
    noise_power], the same for the same generator seed, another for
    another seed; noise_power = 0 draws nothing."""
    c, s, p, _ = level0
    power = 3.0
    args = (CONTENT_INDEX, list(STYLE_INDICES), torch.from_numpy(c),
            torch.from_numpy(s), torch_params, 1e3, 4e5, 1e2)
    noisy = LossBuilder(*args, noise_power=power)
    x = torch.from_numpy(p)

    def content_loss(seed):
        return noisy.build(x, torch.Generator().manual_seed(seed))[1]

    assert torch.equal(content_loss(5), content_loss(5))
    assert not torch.equal(content_loss(5), content_loss(6))
    assert torch.equal(noisy.build(x)[1], content_loss(0))  # default seed 0

    with torch.no_grad():
        target = RepresentationBuilder(torch.from_numpy(c),
                                       torch_params).build_content(
                                           CONTENT_INDEX)
        current = RepresentationBuilder(x, torch_params).build_content(
            CONTENT_INDEX)
    n = torch.randn(target.shape, generator=torch.Generator().manual_seed(5))
    noise = power * torch.clamp(0.5 * n + 0.5, 0.0, 1.0)
    assert float(noise.min()) >= 0.0 and float(noise.max()) <= power
    assert 0.0 < float(noise.mean()) < power
    np.testing.assert_allclose(
        float(content_loss(5)),
        float(torch.mean(torch.square(target + noise - current))), rtol=1e-6)

    quiet = LossBuilder(*args)
    gen = torch.Generator().manual_seed(9)
    state = gen.get_state()
    quiet.build(x, gen)
    assert torch.equal(gen.get_state(), state)


def test_cli_remat_streaming_and_stop_shrink_flags():
    parser = cli.build_parser()
    base = ["--content", "a.jpg", "--style", "b.jpg", "--output", "o.jpg",
            "--device", "cpu"]
    cfg = cli.config_from_args(parser.parse_args(base))
    assert (cfg.remat_levels, cfg.pipeline_streaming, cfg.stop_shrink) == (
        False, True, True)
    cfg = cli.config_from_args(parser.parse_args(
        base + ["--remat-levels", "--no-pipeline-streaming",
                "--no-stop-shrink"]))
    assert (cfg.remat_levels, cfg.pipeline_streaming, cfg.stop_shrink) == (
        True, False, False)
    qparser = queue_cli.build_parser()
    args = qparser.parse_args(["--pair", "a.jpg", "b.jpg", "--output-dir",
                               "out", "--device", "cpu", "--remat-levels",
                               "--pipeline-streaming", "--stop-shrink"])
    cfg = cli.config_from_args(args)
    assert (cfg.remat_levels, cfg.pipeline_streaming, cfg.stop_shrink) == (
        True, True, True)


def test_lazy_exports_resolve_without_jax():
    """Each of the package root's lazy names resolves, in a fresh
    interpreter, and importing them loads neither JAX nor the JAX
    package."""
    code = (
        "import sys\n"
        "import artstyletransfer_tpu_torch as port\n"
        "before = set(sys.modules)\n"
        "names = sorted(port._LAZY)\n"
        "assert all(getattr(port, n) is not None for n in names)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'artstyletransfer_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=_repo_root())
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 20  # with the 4 mesh helpers
    import artstyletransfer_tpu_torch as port

    assert port.TransferJob is TransferJob
    assert port.BatchedTransferJob is BatchedTransferJob
    with pytest.raises(AttributeError):
        port.no_such_name


def _repo_root():
    import os

    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
