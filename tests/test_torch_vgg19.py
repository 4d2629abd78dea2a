"""The port's VGG19 taps against the JAX package's extract_features on the
CPU, with the weights carried across by params_from_jax."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from artstyletransfer_tpu.models.vgg19 import extract_features as jax_feats
from artstyletransfer_tpu_torch.models.vgg19 import (
    CONTENT_INDEX,
    LAYER_NAMES,
    STYLE_INDICES,
    extract_features,
    param_shapes,
    prepare_model,
)
from artstyletransfer_tpu_torch.models import weights as weights_mod
from artstyletransfer_tpu_torch.models.weights import (
    init_vgg19_params,
    load_vgg19_params,
    params_from_jax,
    save_vgg19_params,
)


@pytest.mark.parametrize("use_relu", [True, False])
def test_taps_match_jax(vgg_params, use_relu):
    """Six taps at a 36x52 image (odd pooled sizes: floor pooling).
    float32 oneDNN vs XLA convolutions: rtol 1e-4, atol 1e-4 of each tap's
    largest magnitude."""
    rng = np.random.default_rng(1)
    x = (rng.random((1, 36, 52, 3)) * 255 - 120).astype(np.float32)
    ref = jax_feats(vgg_params, jnp.asarray(x), use_relu=use_relu)
    ours = extract_features(params_from_jax(vgg_params), torch.from_numpy(x),
                            use_relu=use_relu)
    for name, a, b in zip(LAYER_NAMES, ours, ref):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(), err_msg=name)


def test_taps_bf16_close_to_f32(vgg_params):
    """compute_dtype='bfloat16' keeps bf16 taps; each stays within 5% (of
    the tap's largest magnitude) of the float32 run — bf16 keeps 8 bits."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((rng.random((1, 32, 32, 3)) * 255 - 120)
                         .astype(np.float32))
    params = params_from_jax(vgg_params)
    f32 = extract_features(params, x)
    bf16 = extract_features(params, x, compute_dtype="bfloat16")
    for name, a, b in zip(LAYER_NAMES, bf16, f32):
        assert a.dtype == torch.bfloat16, name
        err = (a.float() - b).abs().max() / b.abs().max()
        assert float(err) < 0.05, (name, float(err))


def test_taps_are_nhwc_contiguous(vgg_params):
    """The NHWC taps reshape to (h*w, c) without a copy (channels_last
    convs), which the Gram kernels rely on."""
    x = torch.zeros((1, 32, 32, 3))
    for tap in extract_features(params_from_jax(vgg_params), x):
        assert tap.is_contiguous(), tap.stride()


def test_weights_init_matches_jax(vgg_params):
    ours = init_vgg19_params(seed=0)
    assert set(ours) == set(vgg_params)
    for name in ours:
        np.testing.assert_array_equal(ours[name]["w"], vgg_params[name]["w"])
        np.testing.assert_array_equal(ours[name]["b"], vgg_params[name]["b"])
    assert param_shapes()["conv5_1"]["w"] == (3, 3, 512, 512)


def test_params_from_jax_layout(vgg_params):
    t = params_from_jax(vgg_params)
    w = vgg_params["conv2_1"]["w"]  # HWIO
    np.testing.assert_array_equal(t["conv2_1"]["w"].numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))


def test_npz_roundtrip_and_missing_path(tmp_path, monkeypatch):
    monkeypatch.delenv("ASTT_VGG19_WEIGHTS", raising=False)
    # loading a named file writes the weights cache: keep it in tmp_path
    monkeypatch.setattr(weights_mod, "_CACHE_FILE",
                        str(tmp_path / "cache" / "vgg19_features.npz"))
    p = init_vgg19_params(seed=4)
    path = str(tmp_path / "w.npz")
    save_vgg19_params(p, path)
    back = load_vgg19_params(path)
    np.testing.assert_array_equal(back["conv3_2"]["w"], p["conv3_2"]["w"])
    with pytest.raises(FileNotFoundError):
        load_vgg19_params(str(tmp_path / "missing.npz"))
    monkeypatch.setenv("ASTT_VGG19_WEIGHTS", str(tmp_path / "gone.npz"))
    with pytest.raises(FileNotFoundError):
        load_vgg19_params()


def test_tap_metadata():
    assert CONTENT_INDEX == 4 and tuple(STYLE_INDICES) == (0, 1, 2, 3, 5)
    with pytest.raises(ValueError):
        prepare_model("alexnet")
