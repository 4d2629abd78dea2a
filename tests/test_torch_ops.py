"""The port's ops and host pipeline against the JAX package on the CPU.

level_loss (value and image gradient, both style-backward forms), the
in-graph bicubic downscale, and the host-side numpy pipeline (resize,
pyramids, the three init images), which must be bit-identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.config import Config as JaxConfig
from artstyletransfer_tpu.engine.init_pipeline import build_init_image as jax_init
from artstyletransfer_tpu.engine.pyramid import build_input_pyramids as jax_pyr
from artstyletransfer_tpu.models.vgg19 import extract_features as jax_feats
from artstyletransfer_tpu.ops.gram import gram_matrix as jax_gram
from artstyletransfer_tpu.ops.losses import level_loss as jax_level_loss
from artstyletransfer_tpu.ops.losses import regularization as jax_regularization
from artstyletransfer_tpu.ops.resize import bicubic_resize_np as jax_resize_np
from artstyletransfer_tpu.ops.resize import downscale2x as jax_downscale2x
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine.init_pipeline import build_init_image
from artstyletransfer_tpu_torch.engine.pyramid import build_input_pyramids
from artstyletransfer_tpu_torch.models.vgg19 import extract_features
from artstyletransfer_tpu_torch.models.weights import params_from_jax
from artstyletransfer_tpu_torch.ops.losses import level_loss, regularization
from artstyletransfer_tpu_torch.ops.resize import bicubic_resize_np, downscale2x

STYLE = (0, 1, 2, 3, 5)
WEIGHTS = (1e3, 4e5, 1e2)


@pytest.fixture
def same_native(monkeypatch):
    """Both packages on the same host implementation. Each builds its own
    copy of the native image library at first use and falls back to numpy
    when its copy cannot load; bit-identity holds between like paths, so
    if only one side loaded, both take the numpy path."""
    import artstyletransfer_tpu.native as jax_native
    import artstyletransfer_tpu_torch.native as port_native

    if jax_native.available() != port_native.available():
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)


@pytest.fixture(scope="module")
def level_inputs():
    rng = np.random.default_rng(5)
    x = (rng.random((1, 32, 32, 3)) * 255 - 120).astype(np.float32)
    content = (rng.random((1, 32, 32, 3)) * 255 - 120).astype(np.float32)
    style = (rng.random((1, 32, 32, 3)) * 255 - 120).astype(np.float32)
    return x, content, style


@pytest.mark.parametrize("fused", [True, False])
def test_level_loss_and_grad_match_jax(vgg_params, level_inputs, fused):
    """Same weights, image and targets through both packages. Tolerances:
    rtol 1e-4 on the losses and 1e-3 (relative to the largest entry) on
    the image gradient — float32 convolutions (oneDNN vs XLA) summed in
    different orders through 13 layers."""
    x, content, style = level_inputs
    cfj = jax_feats(vgg_params, jnp.asarray(content))
    sfj = jax_feats(vgg_params, jnp.asarray(style))
    t_content = cfj[4]
    t_grams = tuple(jax_gram(sfj[i]) for i in STYLE)

    def jax_total(xj):
        ll = jax_level_loss(jax_feats(vgg_params, xj), t_content, t_grams,
                            xj, *WEIGHTS, 4, STYLE, fused_style_bwd=fused)
        return ll.total, ll

    (_, ll_j), g_j = jax.value_and_grad(jax_total, has_aux=True)(
        jnp.asarray(x))

    params = params_from_jax(vgg_params)
    xt = torch.from_numpy(x).requires_grad_(True)
    ll_t = level_loss(extract_features(params, xt),
                      torch.from_numpy(np.array(t_content)),
                      [torch.from_numpy(np.array(g)) for g in t_grams],
                      xt, *WEIGHTS, 4, STYLE, fused_style_bwd=fused)
    ll_t.total.backward()
    for name in ("total", "content", "style", "tv"):
        np.testing.assert_allclose(float(getattr(ll_t, name).detach()),
                                   float(getattr(ll_j, name)), rtol=1e-4,
                                   err_msg=name)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())


def test_regularization_matches_jax(rng):
    """The reference's unused (y/128)^10 regularizer: rtol 1e-5."""
    y = (rng.random((1, 8, 8, 3)) * 300 - 150).astype(np.float32)
    np.testing.assert_allclose(float(regularization(torch.from_numpy(y))),
                               float(jax_regularization(jnp.asarray(y))),
                               rtol=1e-5)


def test_downscale2x_matches_jax(rng):
    img = (rng.random((1, 33, 48, 3)) * 200 - 100).astype(np.float32)
    ref = np.asarray(jax_downscale2x(jnp.asarray(img)))
    ours = downscale2x(torch.from_numpy(img)).numpy()
    assert ours.shape == (1, 16, 24, 3)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)


def test_downscale2x_grad_matches_jax(rng):
    img = (rng.random((1, 16, 20, 3))).astype(np.float32)
    w = rng.standard_normal((1, 8, 10, 3)).astype(np.float32)
    g_ref = jax.grad(lambda a: jnp.sum(jax_downscale2x(a) * w))(
        jnp.asarray(img))
    it = torch.from_numpy(img).requires_grad_(True)
    (downscale2x(it) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(it.grad.numpy(), np.asarray(g_ref),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("out_hw", [(74, 106), (19, 27), (37, 53)])
def test_bicubic_resize_np_bit_identical(rng, out_hw, same_native):
    img = rng.random((37, 53, 3)).astype(np.float32)
    np.testing.assert_array_equal(bicubic_resize_np(img, *out_hw),
                                  jax_resize_np(img, *out_hw))
    batch = rng.random((2, 12, 10, 3)).astype(np.float32)  # numpy path
    np.testing.assert_array_equal(bicubic_resize_np(batch, 7, 9),
                                  jax_resize_np(batch, 7, 9))


def test_pyramids_bit_identical(rng, same_native):
    content = rng.random((36, 52, 3)).astype(np.float32)
    style = rng.random((28, 28, 3)).astype(np.float32)
    ours = build_input_pyramids(content, style, 2, 16)
    ref = jax_pyr(content, style, 2, 16)
    for a_levels, b_levels in zip(ours, ref):
        assert len(a_levels) == len(b_levels) == 2
        for a, b in zip(a_levels, b_levels):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["random", "content+noise", "style"])
def test_init_images_bit_identical(rng, method, same_native):
    content = rng.random((36, 52, 3)).astype(np.float32)
    style = rng.random((40, 60, 3)).astype(np.float32)
    kw = dict(levels_num=2, base_diameter=16, seed=3)
    ours, name = build_init_image(method, content, style, Config(**kw),
                                  rng=np.random.default_rng(3))
    ref, ref_name = jax_init(method, content, style, JaxConfig(**kw),
                             rng=np.random.default_rng(3))
    assert name == ref_name
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
