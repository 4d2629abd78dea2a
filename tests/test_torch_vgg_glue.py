"""Vgg19Fn and kernels/vgg_glue.py's plain versions against the per-op
autograd stack they replaced (tests/vgg_per_op.py), bit for bit on the
CPU: the six taps and the input gradient of level_loss summed over two
levels, at odd sizes, three lanes, tied positive maxima and all-zero pool
windows, in float32 and bfloat16, with use_relu on and off, and under
torch.utils.checkpoint; the row blocks' BlockGlueFn against F.relu and
F.max_pool2d. Also: the wrappers refuse other devices, and no kernel of
the module is counted by the benchmark as a convolution."""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from artstyletransfer_tpu_torch import kernels
from artstyletransfer_tpu_torch.kernels import build
from artstyletransfer_tpu_torch.kernels import vgg_glue as kg
from artstyletransfer_tpu_torch.models import vgg19 as V
from artstyletransfer_tpu_torch.models.weights import (init_vgg19_params,
                                                       params_from_jax)
from artstyletransfer_tpu_torch.ops.gram import gram_matrix
from artstyletransfer_tpu_torch.ops.losses import level_loss
from artstyletransfer_tpu_torch.ops.resize import downscale2x
from portbench.metrics.conv_roofline import is_conv
from vgg_per_op import per_op_features


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    """Seeded weights with biases of both signs; in every conv the first
    four output channels are a constant 0.5 (every 2x2 window a tie of
    positive maxima) and the next four a constant -0.5 (all-zero windows
    after the ReLU)."""
    rng = np.random.default_rng(3)
    out = params_from_jax(init_vgg19_params(seed=0))
    for name, p in out.items():
        b = torch.from_numpy(rng.standard_normal(p["b"].shape)
                             .astype(np.float32) * 0.5)
        w = p["w"].clone()
        w[:8] = 0.0
        b[:4], b[4:8] = 0.5, -0.5
        out[name] = {"w": w, "b": b}
    return out


def _image(lanes, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((lanes, h, w, 3)) * 255 - 120)
                            .astype(np.float32))


def _evaluate(features, params, x0, compute_dtype, use_relu, remat=False):
    """The six taps of the top level and the input gradient of level_loss
    summed over two levels (the lower a bicubic downscale), against
    targets of another image."""
    x = x0.clone().requires_grad_(True)
    with torch.no_grad():
        other = _image(x0.shape[0], *x0.shape[1:3], seed=9)
        targets = []
        for img in (other, downscale2x(other)):
            f = features(params, img, compute_dtype, use_relu)
            targets.append((f[V.CONTENT_INDEX].float(),
                            tuple(gram_matrix(f[i]) for i in V.STYLE_INDICES)))
    top, total = None, 0.0
    for lvl, img in enumerate((x, downscale2x(x))):

        def one_level(img, lvl=lvl):
            feats = features(params, img, compute_dtype, use_relu)
            return feats, level_loss(feats, *targets[lvl], img, 1.0, 1e3,
                                     1e-2, V.CONTENT_INDEX, V.STYLE_INDICES)

        if remat:
            feats, ll = checkpoint(one_level, img, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            feats, ll = one_level(img)
        top = feats if top is None else top
        total = total + ll.total
    total.sum().backward()
    return [t.detach() for t in top], total.detach(), x.grad


def _assert_same(got, want):
    (taps_a, loss_a, grad_a), (taps_b, loss_b, grad_b) = got, want
    for name, a, b in zip(V.LAYER_NAMES, taps_a, taps_b):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    assert torch.equal(loss_a, loss_b)
    assert torch.equal(grad_a, grad_b), float((grad_a - grad_b).abs().max())


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_relu", [True, False])
def test_fused_is_the_per_op_stack(params, one_thread, compute_dtype,
                                   use_relu):
    """Three lanes of a 37x45 image (odd at every pool)."""
    x = _image(3, 37, 45)
    _assert_same(_evaluate(V.extract_features, params, x, compute_dtype,
                           use_relu),
                 _evaluate(per_op_features, params, x, compute_dtype,
                           use_relu))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_fused_under_checkpoint(params, one_thread, compute_dtype):
    """Each level under non-reentrant torch.utils.checkpoint (remat_levels)
    gives the per-op stack's bits without it."""
    x = _image(2, 38, 46, seed=1)
    _assert_same(_evaluate(V.extract_features, params, x, compute_dtype,
                           True, remat=True),
                 _evaluate(per_op_features, params, x, compute_dtype, True))


def test_card_arrangement_in_float32(params, one_thread, monkeypatch):
    """The card's arrangement, the convs without their bias and the bias in
    the glue, run on the CPU through the plain versions: in float32 the
    sum rounds once either way, so the bits are the per-op stack's."""
    monkeypatch.setattr(V, "_conv_adds_bias", lambda device: False)
    x = _image(3, 37, 45, seed=2)
    for use_relu in (True, False):
        _assert_same(_evaluate(V.extract_features, params, x, "float32",
                               use_relu),
                     _evaluate(per_op_features, params, x, "float32",
                               use_relu))


class _PerOpBlockGlue:
    """BlockGlueFn's per-op form: F.relu and F.max_pool2d under autograd."""

    @staticmethod
    def apply(h, pool):
        h = F.relu(h)
        return F.max_pool2d(h, kernel_size=2, stride=2) if pool else h


def _blocks_evaluate(params, x0, n, compute_dtype, use_relu):
    """extract_features_blocks over n row blocks (one CPU device): the
    taps and the blocks' input gradients of a sum of sin over every tap,
    so each tap sends its own gradient."""
    xs = [b.clone().requires_grad_(True) for b in x0.chunk(n, dim=1)]
    feats = V.extract_features_blocks([params] * n, xs, compute_dtype,
                                      use_relu)
    sum(torch.sin(t.float()).sum() for f in feats for t in f).backward()
    return [t.detach() for f in feats for t in f], [x.grad for x in xs]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_relu", [True, False])
def test_block_glue_is_the_per_op_glue(params, one_thread, monkeypatch,
                                       compute_dtype, use_relu):
    """The row blocks' glue (BlockGlueFn after each halo'd convolution)
    against F.relu and F.max_pool2d in its place: every block's taps and
    input gradient bit for bit, two lanes of 32x45 in two blocks."""
    x = _image(2, 32, 45, seed=4)
    got = _blocks_evaluate(params, x, 2, compute_dtype, use_relu)
    monkeypatch.setattr(V, "BlockGlueFn", _PerOpBlockGlue)
    want = _blocks_evaluate(params, x, 2, compute_dtype, use_relu)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())


def _halves(shape, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    t = (torch.round(torch.randn(shape, generator=g) * 2) / 2).clamp(-2, 2)
    t = t.to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 \
        else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(6, 8), (7, 9)])
def test_plain_glue_is_the_per_op_glue(dtype, hw):
    """On values of halves (ties and zeros in most windows): the forward's
    pre, post, pooled map and code, and every backward form, against the
    ops they stand for (backward: autograd through them)."""
    b, c = 3, 16
    y = _halves((b, c) + hw, 0, dtype)
    bias = _halves((c,), 1, dtype)
    pre = y + bias.view(1, -1, 1, 1)
    post = F.relu(pre)
    pooled, idx = F.max_pool2d(post, 2, 2, return_indices=True)
    got_pre, got_post, none = kg.glue(y, bias, keep_pre=True)
    assert none is None and torch.equal(got_pre, pre)
    assert torch.equal(got_post, post)
    _, got_pool, code = kg.glue(y, bias, pool=True)
    assert torch.equal(got_pool, pooled) and code.dtype == torch.uint8
    h, w = hw
    want_pos = (idx // w % 2) * 2 + idx % w % 2
    assert torch.equal((code & 3).long(), want_pos)
    assert torch.equal(code >= 4, pooled > 0)
    assert kg.glue(y, bias, keep_post=False, keep_pre=True)[1] is None

    g_up = _halves(tuple(pooled.shape), 2, dtype)
    t = _halves((b, c) + hw, 3, dtype)
    g_in = _halves((b, c) + hw, 4, dtype)
    for form in ("pool", "plain", "post_tap", "pre_tap", "last_post"):
        y_ = y.clone().requires_grad_(True)
        pre_ = y_ + bias.view(1, -1, 1, 1)
        post_ = F.relu(pre_)
        if form == "pool":
            out = F.max_pool2d(post_, 2, 2)
            torch.autograd.backward(out, g_up)
            got = kg.glue_bwd(g_up, code=code, size=hw)
        elif form == "plain":
            torch.autograd.backward(post_, g_in)
            got = kg.glue_bwd(g_in, post=post)
        elif form == "post_tap":
            torch.autograd.backward([post_, post_], [g_in, t])
            got = kg.glue_bwd(g_in, post=post, tap=t)
        elif form == "pre_tap":
            torch.autograd.backward([post_, pre_], [g_in, t])
            got = kg.glue_bwd(g_in, post=post, tap=t, tap_after=True)
        else:
            torch.autograd.backward(post_, t)
            got = kg.glue_bwd(None, post=post, tap=t)
        assert torch.equal(got, y_.grad), form


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor neither on the CPU nor on CUDA raises, and so
    does a CPU tensor handed to a kernel entry point."""
    meta = torch.empty((1, 64, 4, 4), device="meta")
    with pytest.raises(ValueError):
        kg.glue(meta, None)
    with pytest.raises(ValueError):
        kg.glue_bwd(meta, post=meta)
    cpu = torch.zeros((1, 64, 4, 4)).contiguous(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError):
        kg.glue_cuda(cpu, None)
    with pytest.raises(ValueError):
        kg.glue_bwd_cuda(cpu, post=cpu)


def test_cpu_runs_are_not_counted_as_launches(params, one_thread):
    kernels.reset_launches()
    V.extract_features(params, _image(1, 16, 16))
    assert kernels.LAUNCHES["vgg_glue"] == 0
    assert kernels.LAUNCHES["vgg_glue_bwd"] == 0


def test_weights_take_no_gradient(params):
    p = {n: {"w": v["w"].clone().requires_grad_(True), "b": v["b"]}
         for n, v in params.items()}
    with pytest.raises(ValueError):
        V.extract_features(p, _image(1, 16, 16))


def _kernel_names():
    with open(os.path.join(build.SRC_DIR, "vgg_glue.cu")) as fh:
        src = fh.read()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                      r"(\w+)", src)


def test_no_kernel_is_counted_as_a_convolution():
    """conv_roofline reads cuDNN's kernels by name: none of the glue
    kernels, as the profiler names them (template arguments and parameter
    types included), and no LAUNCHES key, may match its is_conv."""
    names = _kernel_names()
    assert sorted(names) == ["vgg_glue_bwd_kernel", "vgg_glue_fwd_kernel"]
    params = {"vgg_glue_fwd_kernel": "{t}*, {t} const*, int, {t}*, "
                                     "unsigned char*, long, int, int, int",
              "vgg_glue_bwd_kernel": "{t} const*, {t} const*, unsigned "
                                     "char const*, {t} const*, int, {t}*, "
                                     "long, int, int, int"}
    for name in names:
        for t in ("float", "__nv_bfloat16"):
            for pool in ("true", "false"):
                full = (f"void {name}<{t}, {pool}>("
                        f"{params[name].format(t=t)})")
                assert not is_conv(full), full
    for key in ("vgg_glue", "vgg_glue_bwd"):
        assert key in kernels.KERNELS and not is_conv(key)
    assert "vgg_glue" in build.SOURCES
