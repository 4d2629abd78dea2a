"""The port's VGG19 weight files (models/weights.py) against the JAX
package's loader, on the CPU.

The seeded weights are written as a torchvision-layout .pth state dict
(features.<idx>.weight, OIHW; torch.save) and as Keras-layout .h5 files
(h5py, every key layout _load_keras_h5 accepts); both packages'
load_vgg19_params must give equal arrays. convert_weights_main writes an
.npz the JAX loader reads. Then the resolution order: a missing explicit
path or environment path raises, a stale cache entry falls through, the
cache is used when present, an unknown suffix raises ValueError. Every
test points both packages' cache file into tmp_path, so none touches the
user's cache; nothing is downloaded.
"""

import os

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.models import weights as jweights
from artstyletransfer_tpu_torch.models import weights as tweights
from artstyletransfer_tpu_torch.models.vgg19 import CONV_NAMES

# the cache paths as the modules set them, before any fixture moves them
_CACHE_PATHS = {"port": (tweights._CACHE_DIR, tweights._CACHE_FILE),
                "jax": (jweights._CACHE_DIR, jweights._CACHE_FILE)}


@pytest.fixture(autouse=True)
def cache_in_tmp(tmp_path, monkeypatch):
    """Both packages' cache file (and its directory) in tmp_path, and no
    weights file named by the environment. Returns the cache path."""
    cache_dir = tmp_path / "cache"
    cache_file = str(cache_dir / "vgg19_features.npz")
    for mod in (jweights, tweights):
        monkeypatch.setattr(mod, "_CACHE_DIR", str(cache_dir))
        monkeypatch.setattr(mod, "_CACHE_FILE", cache_file)
    monkeypatch.delenv("ASTT_VGG19_WEIGHTS", raising=False)
    return cache_file


@pytest.fixture(scope="module")
def seeded():
    return tweights.init_vgg19_params(seed=0)


def _equal(a, b):
    assert set(a) == set(b) == set(CONV_NAMES)
    for name in CONV_NAMES:
        for k in ("w", "b"):
            assert a[name][k].dtype == b[name][k].dtype == np.float32
            np.testing.assert_array_equal(a[name][k], b[name][k])


def _write_pth(params, path, extra=True):
    state = {}
    for name, idx in tweights._TORCHVISION_INDICES.items():
        w = np.transpose(params[name]["w"], (3, 2, 0, 1))  # HWIO -> OIHW
        state[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w))
        state[f"features.{idx}.bias"] = torch.from_numpy(params[name]["b"])
    if extra:  # a torchvision state dict also holds the classifier
        state["classifier.0.weight"] = torch.zeros(4, 4)
    torch.save(state, path)


def _write_h5(params, path, nested, legacy_suffix, model_weights_root):
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights") if model_weights_root else f
        for name, kname in tweights._KERAS_NAMES.items():
            grp = root.create_group(kname)
            if nested:
                grp = grp.create_group(kname)
            suffix = ":0" if legacy_suffix else ""
            grp.create_dataset("kernel" + suffix, data=params[name]["w"])
            grp.create_dataset("bias" + suffix, data=params[name]["b"])


def test_tables_match_jax():
    assert tweights._TORCHVISION_INDICES == jweights._TORCHVISION_INDICES
    assert tweights._KERAS_NAMES == jweights._KERAS_NAMES


def test_cache_file_is_the_jax_packages():
    """One installed file serves both packages."""
    assert _CACHE_PATHS["port"] == _CACHE_PATHS["jax"]
    assert _CACHE_PATHS["port"][1].endswith(
        os.path.join(".cache", "artstyletransfer_tpu", "vgg19_features.npz"))


def test_torchvision_pth_matches_jax(tmp_path, seeded, cache_in_tmp):
    path = str(tmp_path / "vgg19.pth")
    _write_pth(seeded, path)
    ours = tweights.load_vgg19_params(path, cache=False)
    _equal(ours, seeded)
    _equal(ours, jweights.load_vgg19_params(path, cache=False))
    assert not os.path.exists(cache_in_tmp)


@pytest.mark.parametrize("nested,legacy_suffix,model_weights_root", [
    (True, True, True),     # full-model save, TF2-era
    (True, True, False),    # weights-only save, TF2-era
    (False, False, False),  # flat Keras-3 style
])
def test_keras_h5_matches_jax(tmp_path, seeded, nested, legacy_suffix,
                              model_weights_root):
    path = str(tmp_path / "vgg19.h5")
    _write_h5(seeded, path, nested, legacy_suffix, model_weights_root)
    ours = tweights.load_vgg19_params(path, cache=False)
    _equal(ours, seeded)
    _equal(ours, jweights.load_vgg19_params(path, cache=False))


def test_convert_weights_main_writes_npz_jax_reads(tmp_path, seeded,
                                                   cache_in_tmp, capsys):
    src = str(tmp_path / "vgg19.pth")
    _write_pth(seeded, src)
    out = str(tmp_path / "converted.npz")
    assert tweights.convert_weights_main([src, "-o", out]) == 0
    assert "13 conv layers" in capsys.readouterr().out
    _equal(jweights.load_vgg19_params(out, cache=False), seeded)
    assert not os.path.exists(cache_in_tmp)
    # --install: the cache file both packages resolve by default
    assert tweights.convert_weights_main([src, "--install"]) == 0
    _equal(jweights.load_vgg19_params(), seeded)
    _equal(tweights.load_vgg19_params(seed=5), seeded)
    assert (tmp_path / "vgg19.npz").exists()  # default output name


def test_named_file_is_cached_and_the_cache_then_used(tmp_path, seeded,
                                                      monkeypatch):
    """A file named by the environment is converted once into the cache;
    without it the cache wins over the seeded init, in both packages."""
    path = str(tmp_path / "vgg19.pth")
    _write_pth(seeded, path)
    monkeypatch.setenv("ASTT_VGG19_WEIGHTS", path)
    _equal(tweights.load_vgg19_params(seed=3), seeded)
    monkeypatch.delenv("ASTT_VGG19_WEIGHTS")
    _equal(tweights.load_vgg19_params(seed=3), seeded)
    _equal(jweights.load_vgg19_params(seed=3, cache=False), seeded)


def test_explicit_path_wins_over_env_and_cache(tmp_path, seeded,
                                               monkeypatch):
    other = tweights.init_vgg19_params(seed=9)
    env_path = str(tmp_path / "env.npz")
    tweights.save_vgg19_params(other, env_path)
    tweights.save_vgg19_params(other, tweights._CACHE_FILE)
    monkeypatch.setenv("ASTT_VGG19_WEIGHTS", env_path)
    path = str(tmp_path / "explicit.pth")
    _write_pth(seeded, path)
    _equal(tweights.load_vgg19_params(path), seeded)
    _equal(jweights.load_vgg19_params(path, cache=False), seeded)


@pytest.mark.parametrize("where", ["argument", "env"])
def test_missing_named_path_raises(tmp_path, monkeypatch, where):
    missing = str(tmp_path / "no_such_weights.pth")
    tweights.save_vgg19_params(tweights.init_vgg19_params(seed=1),
                               tweights._CACHE_FILE)
    if where == "env":
        monkeypatch.setenv("ASTT_VGG19_WEIGHTS", missing)
        args = ()
    else:
        args = (missing,)
    for mod in (tweights, jweights):
        with pytest.raises(FileNotFoundError):
            mod.load_vgg19_params(*args, cache=False)


def test_stale_cache_falls_through(monkeypatch, capsys):
    """A cache entry listed but gone when read falls through to the seeded
    weights (with a warning) instead of aborting the resolution."""
    real_exists = tweights.os.path.exists
    monkeypatch.setattr(
        tweights.os.path, "exists",
        lambda p: True if p == tweights._CACHE_FILE else real_exists(p))
    _equal(tweights.load_vgg19_params(seed=2),
           tweights.init_vgg19_params(seed=2))
    assert "does not exist" in capsys.readouterr().err


def test_unknown_suffix_raises(tmp_path):
    path = tmp_path / "w.bin"
    path.write_bytes(b"xx")
    for mod in (tweights, jweights):
        with pytest.raises(ValueError, match="format"):
            mod.load_vgg19_params(str(path), cache=False)


def test_shared_params_follow_the_cache(tmp_path, seeded):
    """shared_params(None) keys on the cache file too: installing weights
    gives a new device copy of them, not the seeded copy from before."""
    before = tweights.shared_params(None, seed=11, device="cpu")
    np.testing.assert_array_equal(
        before["conv1_1"]["w"].permute(2, 3, 1, 0).numpy(),
        tweights.init_vgg19_params(seed=11)["conv1_1"]["w"])
    tweights.save_vgg19_params(seeded, tweights._CACHE_FILE)
    after = tweights.shared_params(None, seed=11, device="cpu")
    assert after is not before
    np.testing.assert_array_equal(
        after["conv1_1"]["w"].permute(2, 3, 1, 0).numpy(),
        seeded["conv1_1"]["w"])
