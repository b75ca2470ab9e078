"""The PyTorch port's CUDA kernels against their plain versions, on the card.

This file imports no JAX, so that it runs where only the port's
dependencies are installed:

    python -m pytest tests/test_torch_cuda.py -m cuda

Every test is marked ``cuda`` and skips without a CUDA device.  Inputs
are seeded numpy arrays moved to the card.  Tolerances, float32: the
forward kernel within 1e-5 (kernel and plain version sum in other
orders); the gradient kernel within 1e-5 of the largest plain value (the
same reason); the gradient kernel against itself bit for bit (it sums in
a fixed order).  bfloat16 (levels and cotangent scaled by ``c + 1`` along
the channels, so that a lane that swaps channels shows): every value
within 1 bfloat16 ulp of the plain value (the gradient plus 1e-5 of the
largest plain value), and at most 1% of the values not bit-equal (both
round the same float32 sums once; weights rounded in another place move
about a quarter of the values by an ulp); the gradient against itself bit
for bit.  The same hold at the mask branch's 14 x 14 pooled size, through
the ``_o14`` entry points.
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


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 numbers at ``|x|`` (8 significant bits)."""
    x = x.float().abs()
    _, e = torch.frexp(x)
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x), e - 8))


def _within_bf16_ulp(got, ref, atol=0.0, share=0.01):
    """Every value of ``got`` within 1 bfloat16 ulp of ``ref`` plus
    ``atol``, and at most ``share`` of them not bit-equal."""
    assert got.dtype == ref.dtype == torch.bfloat16
    err = (got.float() - ref.float()).abs()
    assert bool((err <= _bf16_ulp(ref) + atol).all()), err.max().item()
    assert (got != ref).float().mean().item() <= share


def _channel_scaled(a: np.ndarray) -> np.ndarray:
    return a * (np.arange(a.shape[-1]) + 1.0).astype(np.float32)


@pytest.mark.cuda
def test_cuda_bf16_forward_kernel_matches_plain_version(cuda):
    """The bfloat16 forward kernel against the plain bfloat16 version (the
    Pallas kernel's arithmetic), C = 96 and C = 200 (not a multiple of 32)."""
    for seed, c in ((20, 96), (21, 200)):
        rs = np.random.RandomState(seed)
        feats, rois, valid = _case(rs, 2, 20, c)
        feats = [f.to(torch.bfloat16) for f in _on(cuda, *(_channel_scaled(f) for f in feats))]
        rois, valid = _on(cuda, rois, valid)
        fn = kern.RoIAlignForward()
        got = fn(feats, rois, valid, STRIDES)
        ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, STRIDES)
        torch.cuda.synchronize()
        assert (fn.launches, fn.bf16_launches) == (0, 1)
        assert got.dtype == torch.bfloat16 and not got[~valid].any()
        _within_bf16_ulp(got, ref)


@pytest.mark.cuda
def test_cuda_bf16_backward_kernel_matches_plain_and_repeats(cuda):
    """The bfloat16 gradient kernels against ``roi_align_bwd_plain`` on a
    bfloat16 cotangent, each level bfloat16; a second launch gives the same
    bits."""
    rs = np.random.RandomState(22)
    feats, rois, valid = _case(rs, 2, 200, 256, canvas=(96, 128))
    feats = [f.to(torch.bfloat16) for f in _on(cuda, *feats)]
    rois, valid = _on(cuda, rois, valid)
    rf, vf = _flat(rois, valid)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.from_numpy(_channel_scaled(rs.randn(400, 7, 7, 256).astype(np.float32)))
    g = g.to(cuda).to(torch.bfloat16)
    wrapper = kern.RoIAlignBackward()
    got = wrapper.launch(g, shapes, rf, vf, STRIDES)
    again = wrapper.launch(g, shapes, rf, vf, STRIDES)
    ref = kern.roi_align_bwd_plain(g, feats, rois, valid, STRIDES)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.bf16_launches, wrapper.tile_launches) == (0, 2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    scale = max(b.float().abs().max().item() for b in ref)
    for a, b in zip(got, ref):
        _within_bf16_ulp(a, b, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_bf16_autograd_and_per_image_paths(cuda):
    """Forward and gradient kernels in bfloat16 through autograd, batched
    and per image: one bfloat16 launch of each, a bfloat16 gradient per
    level, within the bounds above of autograd of the plain version."""
    rs = np.random.RandomState(23)
    feats, rois, valid = _case(rs, 2, 24, 64)
    feats = [_channel_scaled(f) for f in feats]
    g = torch.from_numpy(rs.randn(2, 24, 7, 7, 64).astype(np.float32)).to(cuda)
    g = g.to(torch.bfloat16)
    rois, valid = _on(cuda, rois, valid)
    batched, per_image = kern.RoIAlignForward(), kern.PerImageRoIAlign()
    impls = {
        "batched": lambda lv: batched(lv, rois, valid, STRIDES),
        "per image": lambda lv: torch.stack([per_image([f[i] for f in lv], rois[i], valid[i],
                                                       STRIDES) for i in range(2)]),
        "plain": lambda lv: roi_align.multilevel_roi_align_fast(lv, rois, valid, STRIDES),
    }
    results = {}
    for name, impl in impls.items():
        levels = [f.to(torch.bfloat16).requires_grad_() for f in _on(cuda, *feats)]
        out = impl(levels)
        out.backward(g)
        results[name] = (out.detach(), [f.grad for f in levels])
    torch.cuda.synchronize()
    assert (batched.bf16_launches, batched.backward.bf16_launches) == (1, 1)
    assert (per_image.batched.bf16_launches, per_image.batched.backward.bf16_launches) == (2, 2)
    out_p, d_p = results["plain"]
    scale = max(b.float().abs().max().item() for b in d_p)
    for name in ("batched", "per image"):
        out_k, d_k = results[name]
        _within_bf16_ulp(out_k, out_p)
        for a, b in zip(d_k, d_p):
            assert a.dtype == torch.bfloat16
            _within_bf16_ulp(a, b, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_wrappers_reject_mixed_dtypes(cuda):
    """Levels of two dtypes, a cotangent of another dtype than the levels',
    tile lists made for the other dtype and bfloat16 channels that are not
    a multiple of 8 raise ``ValueError``; nothing is launched."""
    rs = np.random.RandomState(24)
    feats, rois, valid = _case(rs, 1, 8, 32)
    feats = _on(cuda, *feats)
    rois, valid = _on(cuda, rois, valid)
    rf, vf = _flat(rois, valid)
    fn = kern.RoIAlignForward()
    mixed = [feats[0].to(torch.bfloat16)] + feats[1:]
    with pytest.raises(ValueError):
        fn(mixed, rois, valid, STRIDES)
    with pytest.raises(ValueError):
        fn([f.half() for f in feats], rois, valid, STRIDES)
    with pytest.raises(ValueError):
        fn([f[..., :12].to(torch.bfloat16) for f in feats], rois, valid, STRIDES)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.zeros((8, 7, 7, 32), device=cuda)
    with pytest.raises(ValueError):
        fn.backward.launch(g, shapes, rf, vf, STRIDES, dtype=torch.bfloat16)
    tiles = fn.backward.tile_lists(shapes, rf, vf, STRIDES)
    with pytest.raises(ValueError):
        fn.backward.launch(g.to(torch.bfloat16), shapes, rf, vf, STRIDES, tiles=tiles)
    assert (fn.launches, fn.bf16_launches, fn.backward.launches,
            fn.backward.bf16_launches) == (0, 0, 0, 0)


def _levels(dev, feats, dtype):
    if dtype == torch.bfloat16:
        return [f.to(dtype) for f in _on(dev, *(_channel_scaled(f) for f in feats))]
    return _on(dev, *feats)


def _held(got, ref, dtype, atol):
    if dtype == torch.bfloat16:
        _within_bf16_ulp(got, ref, atol=atol)
    else:
        assert _max_err(got, ref) <= max(atol, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_14_kernels_match_plain_version(cuda, dtype):
    """The 14 x 14 forward and gradient kernels (the mask branch's) against
    their plain versions: RoIs of every size, invalid ones among them; the
    tile bitmap equals the plain mirror's at 14; the gradient repeats bit
    for bit and a cotangent on the invalid RoIs adds nothing; only the
    ``_o14`` entries of the dtype launch."""
    rs = np.random.RandomState(25)
    feats, rois, valid = _case(rs, 2, 40, 96)
    feats = _levels(cuda, feats, dtype)
    rois, valid = _on(cuda, rois, valid)
    rf, vf = _flat(rois, valid)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.from_numpy(_channel_scaled(rs.randn(80, 14, 14, 96).astype(np.float32)))
    g = g.to(cuda).to(dtype)
    fn = kern.RoIAlignForward()
    out = fn(feats, rois, valid, STRIDES, out_size=14)
    ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, STRIDES, out_size=14)
    tiles = fn.backward.tile_lists(shapes, rf, vf, STRIDES, dtype=dtype, out_size=14)
    level_hw = [s[1:3] for s in shapes]
    ref_bitmap = roi_align.tile_bitmap(
        roi_align.tile_keys(rf, vf, level_hw, 40, STRIDES, out_size=14),
        2 * roi_align.tile_grid(level_hw)[2])
    d_got = fn.backward.launch(g, shapes, rf, vf, STRIDES, tiles=tiles)
    d_again = fn.backward.launch(g, shapes, rf, vf, STRIDES)
    leaked = fn.backward.launch(g * (vf == 0)[:, None, None, None], shapes, rf, vf, STRIDES)
    d_ref = kern.roi_align_bwd_plain(g, feats, rois, valid, STRIDES)
    torch.cuda.synchronize()
    bf = dtype == torch.bfloat16
    counts = {k: getattr(fn, k) for k in ("launches", "bf16_launches", "o14_launches",
                                          "bf16_o14_launches")}
    assert counts == {"launches": 0, "bf16_launches": 0, "o14_launches": 0 if bf else 1,
                      "bf16_o14_launches": 1 if bf else 0}
    assert (fn.backward.o14_launches, fn.backward.bf16_o14_launches) == ((0, 3) if bf else (3, 0))
    assert (fn.backward.tile_launches, fn.backward.o14_tile_launches) == (0, 3)
    assert out.dtype == dtype and tuple(out.shape) == (2, 40, 14, 14, 96)
    assert not out[~valid].any()
    _held(out, ref, dtype, 0.0)
    assert torch.equal(tiles.bitmap.long() & 0xFFFFFFFF, ref_bitmap)
    assert all(torch.equal(a, b) for a, b in zip(d_got, d_again))
    assert all(torch.count_nonzero(d).item() == 0 for d in leaked)
    scale = max(b.float().abs().max().item() for b in d_ref)
    for a, b in zip(d_got, d_ref):
        assert a.dtype == dtype
        _held(a, b, dtype, 1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_14_autograd_and_per_image_paths(cuda, dtype):
    """At 14 x 14, batched through autograd and per image (K2/K3 at 14):
    one launch of each ``_o14`` kernel a call, against autograd of the
    plain version."""
    rs = np.random.RandomState(26)
    feats, rois, valid = _case(rs, 2, 24, 64)
    g = torch.from_numpy(rs.randn(2, 24, 14, 14, 64).astype(np.float32)).to(cuda).to(dtype)
    rois, valid = _on(cuda, rois, valid)
    batched, per_image = kern.RoIAlignForward(), kern.PerImageRoIAlign()
    impls = {
        "batched": lambda lv: batched(lv, rois, valid, STRIDES, out_size=14),
        "per image": lambda lv: torch.stack([per_image([f[i] for f in lv], rois[i], valid[i],
                                                       STRIDES, out_size=14)
                                             for i in range(2)]),
        "plain": lambda lv: roi_align.multilevel_roi_align_fast(lv, rois, valid, STRIDES,
                                                                out_size=14),
    }
    results = {}
    for name, impl in impls.items():
        levels = [f.requires_grad_() for f in _levels(cuda, feats, dtype)]
        out = impl(levels)
        out.backward(g)
        results[name] = (out.detach(), [f.grad for f in levels])
    torch.cuda.synchronize()
    name = "bf16_o14_launches" if dtype == torch.bfloat16 else "o14_launches"
    assert (getattr(batched, name), getattr(batched.backward, name)) == (1, 1)
    assert (getattr(per_image.batched, name), getattr(per_image.batched.backward, name)) == (2, 2)
    out_p, d_p = results["plain"]
    scale = max(b.float().abs().max().item() for b in d_p)
    for key in ("batched", "per image"):
        out_k, d_k = results[key]
        _held(out_k, out_p, dtype, 0.0)
        for a, b in zip(d_k, d_p):
            assert a.dtype == dtype
            _held(a, b, dtype, 1e-5 * scale)
