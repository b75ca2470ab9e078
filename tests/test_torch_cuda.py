"""The PyTorch port's CUDA kernels against their plain versions, on the card.

This file imports no JAX, so that it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test is marked ``cuda`` and skips without a CUDA device.  Inputs
are seeded numpy arrays moved to the card.  Tolerances, float32: the
forward kernel within 1e-5 (kernel and plain version sum in other
orders); the gradient kernel within 1e-5 of the largest plain value (the
same reason); the gradient kernel against itself bit for bit (it sums in
a fixed order).
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boosting_rcnn_tpu_torch.ops import roi_align  # noqa: E402
from boosting_rcnn_tpu_torch.ops import roi_align_kernel as kern  # noqa: E402

STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _case(rs, b, r, c, canvas=(200, 264)):
    """Seeded pyramid (B, H, W, C) per level on the canvas, RoIs of every
    size (some wider than the 24-cell window, some at the edges) and a
    validity mask with the last two RoIs of each image invalid."""
    h, w = canvas
    feats = [rs.randn(b, -(-h // s), -(-w // s), c).astype(np.float32) for s in STRIDES]
    xy = rs.uniform(0, [w - 10, h - 10], (b, r, 2))
    wh = rs.uniform(4, [w, h], (b, r, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(np.float32)
    rois[:, 0] = [w - 250.0, h - 190.0, w, h]  # reaches the bottom-right corner
    rois[:, 1] = [2.0, 10.0, 250.0, 22.0]  # 31 cells wide on P3
    valid = np.ones((b, r), bool)
    valid[:, -2:] = False
    return feats, rois, valid


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _max_err(got, ref):
    return (got - ref).abs().max().item()


def _flat(rois, valid):
    return rois.reshape(-1, 4).contiguous(), valid.reshape(-1).to(torch.uint8)


@pytest.mark.cuda
def test_cuda_backward_kernel_matches_plain_version(cuda):
    """The gradient kernel against ``roi_align_bwd_plain`` on the same CUDA
    inputs, the tile bitmap against the plain mirror; a cotangent on invalid
    RoIs only adds nothing."""
    rs = np.random.RandomState(16)
    feats, rois, valid = _case(rs, 2, 20, 96)
    feats = _on(cuda, *feats)
    rois, valid = _on(cuda, rois, valid)
    rf, vf = _flat(rois, valid)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.from_numpy(rs.randn(40, 7, 7, 96).astype(np.float32)).to(cuda)
    wrapper = kern.RoIAlignBackward()
    tiles = wrapper.tile_lists(shapes, rf, vf, STRIDES)
    level_hw = [s[1:3] for s in shapes]
    ref_bitmap = roi_align.tile_bitmap(roi_align.tile_keys(rf, vf, level_hw, 20, STRIDES),
                                       2 * roi_align.tile_grid(level_hw)[2])
    got = wrapper.launch(g, shapes, rf, vf, STRIDES, tiles=tiles)
    ref = kern.roi_align_bwd_plain(g, feats, rois, valid, STRIDES)
    invalid_only = wrapper.launch(g * (~valid.reshape(-1))[:, None, None, None], shapes, rf, vf,
                                  STRIDES)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.tile_launches) == (2, 2)
    assert torch.equal(tiles.bitmap.long() & 0xFFFFFFFF, ref_bitmap)
    for a, b in zip(got, ref):
        assert _max_err(a, b) <= 1e-5 * b.abs().max().item()
    assert all(torch.count_nonzero(d).item() == 0 for d in invalid_only)


@pytest.mark.cuda
def test_cuda_backward_kernel_is_bitwise_repeatable(cuda):
    """Two launches of the gradient kernel on the same inputs, many RoIs
    on few tiles, give the same bits."""
    rs = np.random.RandomState(19)
    feats, rois, valid = _case(rs, 2, 200, 256, canvas=(96, 128))
    shapes = [f.shape for f in feats]
    rf, vf = _flat(*_on(cuda, rois, valid))
    g = torch.from_numpy(rs.randn(400, 7, 7, 256).astype(np.float32)).to(cuda)
    wrapper = kern.RoIAlignBackward()
    first = wrapper.launch(g, shapes, rf, vf, STRIDES)
    second = wrapper.launch(g, shapes, rf, vf, STRIDES)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_autograd_path_matches_plain_autograd(cuda):
    """``batched_multilevel_roi_align`` on CUDA tensors that need a
    gradient: the forward kernel, then the gradient kernels through the
    autograd Function, one gradient per level, against autograd of the
    plain version; one launch of each."""
    rs = np.random.RandomState(17)
    feats, rois, valid = _case(rs, 2, 24, 64)
    g = torch.from_numpy(rs.randn(2, 24, 7, 7, 64).astype(np.float32)).to(cuda)
    rois, valid = _on(cuda, rois, valid)
    fn = kern.RoIAlignForward()
    results = []
    for impl in (lambda lv: fn(lv, rois, valid, STRIDES),
                 lambda lv: roi_align.multilevel_roi_align_fast(lv, rois, valid, STRIDES)):
        levels = [f.requires_grad_() for f in _on(cuda, *feats)]
        out = impl(levels)
        out.backward(g)
        results.append((out.detach(), [f.grad for f in levels]))
    torch.cuda.synchronize()
    (out_k, d_k), (out_p, d_p) = results
    assert (fn.launches, fn.backward.launches, fn.backward.tile_launches) == (1, 1, 1)
    assert _max_err(out_k, out_p) <= 1e-5
    for a, b in zip(d_k, d_p):
        assert _max_err(a, b) <= 1e-5 * max(b.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_cuda_per_image_entry_matches_plain_version(cuda):
    """The per-image entry (batch of one of both kernels) against the
    plain version of one image, forward and gradient."""
    rs = np.random.RandomState(18)
    feats, rois, valid = _case(rs, 1, 16, 32)
    g = torch.from_numpy(rs.randn(16, 7, 7, 32).astype(np.float32)).to(cuda)
    rois, valid = _on(cuda, rois[0], valid[0])
    entry = kern.PerImageRoIAlign()
    results = []
    for impl in (lambda lv: entry(lv, rois, valid, STRIDES),
                 lambda lv: roi_align.multilevel_roi_align_fast(
                     [f[None] for f in lv], rois[None], valid[None], STRIDES)[0]):
        levels = [f[0].requires_grad_() for f in _on(cuda, *feats)]
        out = impl(levels)
        out.backward(g)
        results.append((out.detach(), [f.grad for f in levels]))
    torch.cuda.synchronize()
    (out_k, d_k), (out_p, d_p) = results
    assert (entry.batched.launches, entry.batched.backward.launches) == (1, 1)
    assert _max_err(out_k, out_p) <= 1e-5
    for a, b in zip(d_k, d_p):
        assert _max_err(a, b) <= 1e-5 * max(b.abs().max().item(), 1e-30)
