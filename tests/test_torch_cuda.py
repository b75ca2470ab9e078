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
the ``_o14`` entry points.  A Res2Net stage-mode block (its last split
average-pooled) on a channels-last input: the gradients of the input and
of every parameter within 1e-4 of their largest CPU value.
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


MASK_STRIDES = (4, 8, 16, 32)  # Mask R-CNN's route levels, P2-P5


def _mask_case(rs, kind, c):
    """Inputs of the 14 x 14 forward's work split: ``single`` one valid RoI;
    ``all valid`` 200 detections of two images, every one valid (the mask
    predict shapes); ``few valid`` 1024 slots with 16 valid (the mask train
    shapes); ``edges`` RoIs on the right and bottom edges of the levels and
    wider than the 24-cell window, some invalid."""
    h, w = (200, 264) if kind != "all valid" else (320, 480)
    b, r = {"single": (1, 1), "all valid": (2, 100), "few valid": (2, 512), "edges": (2, 12)}[kind]
    feats = [rs.randn(b, -(-h // s), -(-w // s), c).astype(np.float32) for s in MASK_STRIDES]
    xy = rs.uniform(0, [w - 10, h - 10], (b, r, 2))
    wh = rs.uniform(4, [w / 2, h / 2], (b, r, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(np.float32)
    valid = np.ones((b, r), bool)
    if kind == "few valid":
        valid[:] = False
        valid.reshape(-1)[rs.choice(b * r, 16, replace=False)] = True
    if kind == "edges":
        rois[:, :6] = [[w - 30, h - 20, w, h], [0, 0, w, h], [w - 200, 0, w, h],
                       [0, h - 120, w, h], [w - 8, h - 8, w, h], [2, 10, w - 2, 30]]
        valid[:, -2:] = False
    return feats, rois, valid


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,c", [("single", 256), ("all valid", 256), ("few valid", 256),
                                    ("edges", 256), ("edges", 40)])
def test_cuda_14_forward_work_split(cuda, dtype, kind, c):
    """The 14 x 14 forward (work items of one valid RoI, bin row and 256
    channels; the invalid slots zeroed by the same blocks) against its plain
    version on the cases that cut its work differently: bfloat16 bit for
    bit, float32 within 1e-5; the invalid slots zero; one launch."""
    rs = np.random.RandomState(30 + len(kind) + c)
    feats, rois, valid = _mask_case(rs, kind, c)
    feats = _levels(cuda, feats, dtype)
    rois, valid = _on(cuda, rois, valid)
    fn = kern.RoIAlignForward()
    got = fn(feats, rois, valid, MASK_STRIDES, out_size=14)
    ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, MASK_STRIDES, out_size=14)
    torch.cuda.synchronize()
    name = "bf16_o14_launches" if dtype == torch.bfloat16 else "o14_launches"
    assert getattr(fn, name) == 1
    assert got.dtype == dtype and got.shape == ref.shape
    assert not got[~valid].any()
    if dtype == torch.bfloat16:
        assert torch.equal(got, ref)
    else:
        assert _max_err(got, ref) <= 1e-5


def _hot_case(rs, b, r, c, spread):
    """RoIs of 20-60 px around (64, 64) +- ``spread`` px on a 128 x 160
    canvas, so that one gradient tile of P3 lists most of them."""
    h, w = 128, 160
    feats = [rs.randn(b, -(-h // s), -(-w // s), c).astype(np.float32) for s in STRIDES]
    ctr = 64 + rs.uniform(-spread, spread, (b, r, 2))
    half = rs.uniform(10, 30, (b, r, 2))
    rois = np.concatenate([ctr - half, ctr + half], -1).clip(0, [w, h, w, h]).astype(np.float32)
    valid = rs.rand(b, r) < 0.97
    return feats, rois, valid


@pytest.mark.cuda
@pytest.mark.parametrize("b,r,c,spread", [(2, 120, 256, 6.0), (1, 2200, 64, 40.0)])
def test_cuda_bf16_backward_hot_tiles(cuda, b, r, c, spread):
    """The bfloat16 gradient at 7 x 7 where a tile's RoIs come in many
    chunks: a tile that lists ~100 RoIs, and 2200 RoIs in one image (past
    the 2048-entry list window); within 1 ulp (+1e-5 x max) of the plain
    version with at most 1% of the values not bit-equal, and bitwise equal
    across two launches."""
    rs = np.random.RandomState(40 + b)
    feats, rois, valid = _hot_case(rs, b, r, c, spread)
    feats = _levels(cuda, feats, torch.bfloat16)
    rois, valid = _on(cuda, rois, valid)
    rf, vf = _flat(rois, valid)
    shapes = [tuple(f.shape) for f in feats]
    g = torch.from_numpy(_channel_scaled(rs.randn(b * r, 7, 7, c).astype(np.float32)))
    g = g.to(cuda).to(torch.bfloat16)
    wrapper = kern.RoIAlignBackward()
    tiles = wrapper.tile_lists(shapes, rf, vf, STRIDES, dtype=torch.bfloat16)
    got = wrapper.launch(g, shapes, rf, vf, STRIDES, tiles=tiles)
    again = wrapper.launch(g, shapes, rf, vf, STRIDES, tiles=tiles)
    ref = kern.roi_align_bwd_plain(g, feats, rois, valid, STRIDES)
    torch.cuda.synchronize()
    assert int(roi_align.tile_counts(tiles.bitmap).max()) > 2 * 16
    assert wrapper.bf16_launches == 2
    assert all(torch.equal(a, x) for a, x in zip(got, again))
    scale = max(x.float().abs().max().item() for x in ref)
    for a, x in zip(got, ref):
        _within_bf16_ulp(a, x, atol=1e-5 * scale)


def _box_case(rs, kind, c):
    """Inputs of the 7 x 7 forward's runs of RoIs: ``single`` one valid
    RoI; ``predict`` 512 RoIs of two images, all valid (the flagship's
    predict shapes); ``train`` 2048 of four images, all valid (its train
    shapes); ``few valid`` 1024 slots with 16 valid; ``edges`` RoIs on the
    right and bottom edges of the levels, wider than the 24-cell window and
    reversed, some invalid."""
    h, w = (320, 480)
    b, r = {"single": (1, 1), "predict": (2, 256), "train": (4, 512), "few valid": (2, 512),
            "edges": (2, 12)}[kind]
    feats = [rs.randn(b, -(-h // s), -(-w // s), c).astype(np.float32) for s in STRIDES]
    xy = rs.uniform(0, [w - 10, h - 10], (b, r, 2))
    wh = rs.uniform(4, [w / 2, h / 2], (b, r, 2))
    rois = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(np.float32)
    valid = np.ones((b, r), bool)
    if kind == "few valid":
        valid[:] = False
        valid.reshape(-1)[rs.choice(b * r, 16, replace=False)] = True
    if kind == "edges":
        rois[:, :6] = [[w - 30, h - 20, w, h], [0, 0, w, h], [w - 200, 0, w, h],
                       [0, h - 120, w, h], [w - 8, h - 8, w, h], [2, 10, w - 2, 30]]
        # reversed (x2 < x1, y2 < y1): each bin's samples descend
        rois[:, 6:9] = [[60, 40, 31, 75], [200, 130, 150, 90], [w - 5, h - 5, w - 97, h - 61]]
        valid[:, -2:] = False
    return feats, rois, valid


@pytest.mark.cuda
@pytest.mark.parametrize("c", [256, 40])
@pytest.mark.parametrize("kind", ["single", "predict", "train", "few valid", "edges"])
def test_cuda_bf16_forward_7_bit_equal(cuda, kind, c):
    """The bfloat16 forward at 7 x 7 (runs of RoIs a block, each bin's taps
    in fixed-count lists) bit for bit against its plain version on the
    cases that cut its runs differently; the invalid slots zero; one
    launch."""
    rs = np.random.RandomState(60 + len(kind) + c)
    feats, rois, valid = _box_case(rs, kind, c)
    feats = _levels(cuda, feats, torch.bfloat16)
    rois, valid = _on(cuda, rois, valid)
    fn = kern.RoIAlignForward()
    got = fn(feats, rois, valid, STRIDES)
    ref = roi_align.multilevel_roi_align_fast(feats, rois, valid, STRIDES)
    torch.cuda.synchronize()
    assert (fn.launches, fn.bf16_launches) == (0, 1)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    assert not got[~valid].any()
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_cuda_bf16_backward_on_an_empty_bitmap(cuda):
    """The bfloat16 gradient at 7 x 7 on tile lists with no RoI (an empty
    bitmap) stores every cell of every level, zeros (the kernel's stores
    alone), whatever the cotangent."""
    rs = np.random.RandomState(52)
    feats, rois, valid = _case(rs, 2, 30, 64)
    shapes = [tuple(f.shape) for f in feats]
    rf, vf = _flat(*_on(cuda, rois, valid))
    g = torch.from_numpy(rs.randn(60, 7, 7, 64).astype(np.float32)).to(cuda).to(torch.bfloat16)
    wrapper = kern.RoIAlignBackward()
    tiles = wrapper.tile_lists(shapes, rf, vf, STRIDES, dtype=torch.bfloat16)
    empty = tiles._replace(bitmap=torch.zeros_like(tiles.bitmap))
    poison = [torch.full(s, float("nan"), dtype=torch.bfloat16, device=cuda) for s in shapes]
    del poison  # the allocator hands the gradients memory that held NaNs
    got = wrapper.launch(g, shapes, rf, vf, STRIDES, tiles=empty)
    torch.cuda.synchronize()
    assert all(d.dtype == torch.bfloat16 and tuple(d.shape) == s for d, s in zip(got, shapes))
    assert all(int(torch.count_nonzero(d)) == 0 for d in got)


@pytest.mark.cuda
def test_cuda_res2net_block_gradient_matches_cpu(cuda):
    """A stride-2 ``Bottle2neck`` on a channels-last map (as the port's
    features get it from NHWC images): the split it average-pools is a
    channel slice, whose CUDA ``avg_pool2d`` backward in PyTorch 2.11 gave
    wrong gradients when it was not made contiguous first.  In float32
    with TF32 off, as the port's float32 checks run: cuDNN's default TF32
    rounds the convolutions' inputs far past this bound."""
    from boosting_rcnn_tpu_torch.models.backbones.res2net import Bottle2neck

    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randn(2, 32, 20, 24).astype(np.float32))
    g = torch.from_numpy(rs.randn(2, 64, 10, 12).astype(np.float32))
    grads = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", cuda):
            block = Bottle2neck(32, 16, 2, True, torch.Generator().manual_seed(0), base_width=8,
                                base_channels=16).to(dev)
            xi = x.to(dev).contiguous(memory_format=torch.channels_last).requires_grad_()
            (block(xi) * g.to(dev)).sum().backward()
            grads[str(dev)] = {"input": xi.grad.cpu(),
                               **{k: p.grad.cpu() for k, p in block.named_parameters()}}
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for k, ref in grads["cpu"].items():
        got = grads[str(cuda)][k]
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item(), k


def _tiny_cascade_inputs(rs):
    """The tiny ProbCascade's batch (two 128 x 160 images, 5 gt boxes each)
    and its stages' sampler uniforms, made with numpy: every device samples
    alike."""
    gts = np.zeros((2, 5, 4), np.float32)
    wh = rs.uniform(12, 70, (2, 5, 2))
    xy = rs.uniform(0, 1, (2, 5, 2)) * ([150.0, 116.0] - wh)
    gts[:] = np.concatenate([xy, xy + wh], -1)
    batch = {"images": rs.randn(2, 128, 160, 3).astype(np.float32),
             "img_shape": np.array([[128.0, 150.0], [116.0, 160.0]], np.float32),
             "scale_factor": np.array([[1.0] * 4, [1.25] * 4], np.float32),
             "gt_bboxes": gts, "gt_labels": rs.randint(0, 4, (2, 5)),
             "gt_mask": np.ones((2, 5), bool)}
    sizes = (5 + 64, 5 + 32, 5 + 32)  # the gt boxes, then the proposals or the slots before
    return batch, [rs.rand(2, 2, n).astype(np.float32) for n in sizes]


@pytest.mark.cuda
def test_cuda_tiny_cascade_matches_cpu(cuda):
    """The tiny ProbCascade (``configs/ensemble/prob_cascade_rcnn_r50_pafpn_
    1x_utdac.py`` at ``--tiny``) on the card against the CPU in float32
    with TF32 off: ``predict`` (labels and valid equal, detections within
    1e-3; the forward kernel once a stage) and a train step on the same
    stage draws (metrics rtol 1e-4; the forward, tile-key and gradient
    kernels once a stage)."""
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.config import load_config
    from boosting_rcnn_tpu_torch.engine.runner import shrink_model
    from boosting_rcnn_tpu_torch.engine.train import make_optimizer, make_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mc = shrink_model(load_config(os.path.join(
        repo, "configs/ensemble/prob_cascade_rcnn_r50_pafpn_1x_utdac.py")).model.to_dict())
    batch, uniforms = _tiny_cascade_inputs(np.random.RandomState(9))
    fwd, bwd = kern.batched_multilevel_roi_align, kern.batched_multilevel_roi_align.backward
    outs, metrics, counts = {}, {}, {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    try:
        for dev in ("cpu", cuda):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            det = build_detector(mc, device=dev, seed=2)
            anchors, nla = det.anchors_for((128, 160))
            fwd.launches = bwd.launches = bwd.tile_launches = 0
            outs[str(dev)] = [x.cpu() for x in det.predict(batch, anchors, nla)]
            counts[str(dev)] = [fwd.launches]
            step = make_train_step(det, anchors, nla,
                                   make_optimizer(det.net.parameters(), lambda s: 0.01))
            m = step(batch, roi_uniforms=uniforms)
            metrics[str(dev)] = {k: float(v) for k, v in m.items()}
            counts[str(dev)] += [fwd.launches, bwd.launches, bwd.tile_launches]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
    (d0, l0, v0), (d1, l1, v1) = outs["cpu"], outs[str(cuda)]
    assert torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any()
    assert _max_err(d1, d0) <= 1e-3
    assert counts["cpu"] == [0, 0, 0, 0] and counts[str(cuda)] == [3, 6, 3, 3]
    assert {"s0.loss_cls", "s1.loss_bbox", "s2.loss_cls"} <= set(metrics["cpu"])
    for k, ref in metrics["cpu"].items():
        assert abs(metrics[str(cuda)][k] - ref) <= 1e-4 * abs(ref), k


def _tiny_htc_config():
    """HTC with the semantic branch at the CPU tests' size
    (``tests/test_torch_htc.py::tiny_htc``, copied: that file imports JAX)."""
    from boosting_rcnn_tpu_torch.config import load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    mc = load_config(os.path.join(repo, "configs/htc/htc_r50_fpn_1x_coco.py")).model.to_dict()
    mc["backbone"].update(depth=18, base_channels=8)
    mc["neck"].update(in_channels=[8, 16, 32, 64], out_channels=16)
    mc["rpn_head"].update(feat_channels=16)
    for h in mc["roi_head"]["bbox_head"]:
        h.update(fc_out_channels=16, num_classes=4)
    for h in mc["roi_head"]["mask_head"]:
        h.update(num_classes=4, conv_out_channels=8, num_convs=1)
    mc["roi_head"]["semantic_head"].update(num_classes=6, conv_out_channels=16, num_convs=1)
    mc["train_cfg"]["rpn_proposal"].update(nms_pre=64, max_per_img=32)
    for rc in mc["train_cfg"]["rcnn"]:
        rc["sampler"]["num"] = 8
    mc["test_cfg"]["rpn"].update(nms_pre=48, max_per_img=16)
    return mc


def _tiny_htc_inputs(rs, num_anchors):
    """Two 128 x 160 images with 5 gt boxes, an ellipse mask each and a
    stuff map at stride 8 (a band of 255), and the draws of every sampler:
    the RPN's, each stage's (over the gt boxes and 32 proposals, then the
    8 slots before) and each stage's mask branch (the 8 slots)."""
    batch, _ = _tiny_cascade_inputs(rs)
    y, x = np.mgrid[:28, :28] + 0.5
    cy, cx, ry, rx = (rs.uniform(lo, hi, (2, 5, 1, 1)) * 28
                      for lo, hi in ((0.3, 0.7), (0.3, 0.7), (0.2, 0.5), (0.2, 0.5)))
    batch["gt_mask_crops"] = ((((y - cy) / ry) ** 2 + ((x - cx) / rx) ** 2) <= 1).astype(np.uint8)
    batch["gt_labels"] = rs.randint(0, 4, (2, 5))
    seg = rs.randint(0, 6, (2, 16, 20))
    seg[0, 4:6] = 255
    batch["gt_semantic_seg"] = seg
    draws = {"rpn_uniforms": rs.rand(2, 2, num_anchors).astype(np.float32),
             "roi_uniforms": [rs.rand(2, 2, n).astype(np.float32) for n in (5 + 32, 13, 13)],
             "mask_uniforms": [rs.rand(2, 2, 13).astype(np.float32) for _ in range(3)]}
    return batch, draws


@pytest.mark.cuda
def test_cuda_tiny_htc_matches_cpu(cuda):
    """The tiny HTC on the card against the CPU in float32 with TF32 off:
    ``predict`` (labels and valid equal; detections within 1e-3 and masks
    within 1e-4, or within 4 times what the CPU's own ``predict`` moves
    when its images change by 1e-7 of their values, where that is more:
    three refinements make this model's boxes move by up to 1.6e-3 px
    under such a change; K1 at 7 six times, three stages on the pyramid
    and on the semantic level, and at 14 twice) and a train step on the same draws
    (losses rtol 1e-4, the gradient norm within 3e-4, ``chip_smoke.py``'s
    float32 rule; K1, K4 and the tile keys at 7 and at 14 six times
    each); then K1 and K4 at 7 and 14 on the one semantic level against
    their plain versions."""
    from boosting_rcnn_tpu_torch.builder import build_detector
    from boosting_rcnn_tpu_torch.engine.train import make_optimizer, make_train_step

    mc = _tiny_htc_config()
    fwd, bwd = kern.batched_multilevel_roi_align, kern.batched_multilevel_roi_align.backward
    names = ("launches", "o14_launches")
    outs, metrics, counts = {}, {}, {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    threads = torch.get_num_threads()
    try:
        for dev in ("cpu", cuda):
            torch.set_num_threads(1 if dev == "cpu" else threads)
            det = build_detector(mc, device=dev, seed=4)
            anchors, nla = det.anchors_for((128, 160))
            batch, draws = _tiny_htc_inputs(np.random.RandomState(12), anchors.shape[0])
            for w, attr in ((fwd, n) for n in names):
                setattr(w, attr, 0)
            for attr in names + ("tile_launches", "o14_tile_launches"):
                setattr(bwd, attr, 0)
            outs[str(dev)] = [x.cpu() for x in det.predict(batch, anchors, nla)]
            counts[str(dev)] = [getattr(fwd, n) for n in names]
            if dev == "cpu":  # the model's own float32 sensitivity
                nudge = 1 + 1e-7 * np.random.RandomState(14).randn(*batch["images"].shape)
                noisy = det.predict({**batch, "images": (batch["images"] * nudge).astype(
                    np.float32)}, anchors, nla)
                noise = [_max_err(a, b) for a, b in zip(noisy[::3], outs["cpu"][::3])]
            step = make_train_step(det, anchors, nla,
                                   make_optimizer(det.net.parameters(), lambda s: 0.01))
            m = step(batch, **draws)
            metrics[str(dev)] = {k: float(v) for k, v in m.items()}
            counts[str(dev)] += [getattr(w, n) for w in (fwd, bwd) for n in names] + [
                bwd.tile_launches, bwd.o14_tile_launches]
            if dev == cuda:
                feats = det.net.features(torch.from_numpy(batch["images"]).to(cuda))
                sem = det.net.semantic_out(feats)[1].detach()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_num_threads(threads)
    (d0, l0, v0, m0), (d1, l1, v1, m1) = outs["cpu"], outs[str(cuda)]
    assert torch.equal(v0, v1) and torch.equal(l0, l1) and v0.any()
    assert _max_err(d1, d0) <= max(1e-3, 4 * noise[0]), (_max_err(d1, d0), noise)
    assert _max_err(m1, m0) <= max(1e-4, 4 * noise[1]), (_max_err(m1, m0), noise)
    assert counts["cpu"] == [0] * 8 and counts[str(cuda)] == [6, 2, 12, 8, 6, 6, 6, 6]
    assert {"loss_semantic_seg", "s0.loss_mask", "s2.loss_mask"} <= set(metrics["cpu"])
    for k, ref in metrics["cpu"].items():
        rtol = 3e-4 if k == "grad_norm" else 1e-4
        assert abs(metrics[str(cuda)][k] - ref) <= rtol * abs(ref), k
    # the one semantic level: every RoI routes to it
    rs = np.random.RandomState(13)
    _, rois, valid = _case(rs, 2, 24, 16, canvas=(128, 160))
    rois, valid = _on(cuda, rois, valid)
    for out_size in (7, 14):
        got = fwd([sem], rois, valid, (8,), out_size=out_size, num_route_levels=1)
        ref = roi_align.multilevel_roi_align_fast([sem], rois, valid, (8,), out_size=out_size)
        assert _max_err(got, ref) <= 1e-5
        g = torch.from_numpy(rs.randn(48, out_size, out_size, 16).astype(np.float32)).to(cuda)
        rf, vf = _flat(rois, valid)
        grads = bwd.launch(g, [tuple(sem.shape)], rf, vf, (8,))
        again = bwd.launch(g, [tuple(sem.shape)], rf, vf, (8,))
        ref_g = kern.roi_align_bwd_plain(g, [sem], rois, valid, (8,))
        torch.cuda.synchronize()
        assert torch.equal(grads[0], again[0])
        assert _max_err(grads[0], ref_g[0]) <= 1e-5 * ref_g[0].abs().max().item()
