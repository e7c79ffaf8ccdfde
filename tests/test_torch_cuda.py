"""Tests that need the card: the CUDA kernels against their plain PyTorch
versions. They skip without an NVIDIA card (a CUDA kernel has no CPU mode).

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpuseg_torch.infer import head_kernel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(ncls, fp, seed, b, h, w, c4, dev):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c4)).astype(np.int8)).to(dev)
    sv = torch.from_numpy(rng.uniform(0.01, 0.1, (c4,)).astype(np.float32)).to(dev)
    epi = rng.normal(0, 1, (4, 4 * ncls)).astype(np.float32)
    if fp:
        wt = torch.from_numpy(rng.normal(0, 0.3, (4 * ncls, c4)).astype(np.float32))
        wt = wt.to(torch.bfloat16)
        epi[3] = 1.0
    else:
        wt = torch.from_numpy(rng.integers(-127, 128, (4 * ncls, c4)).astype(np.int8))
        epi[3] = rng.uniform(1e-4, 1e-3, 4 * ncls)
    return x, sv, wt.to(dev), torch.from_numpy(epi).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [1, 2, 3, 5, 8])
def test_head_kernel_matches_plain(cuda, ncls, fp):
    """int8 head: bit-equal labels; fp head: the same f32 products summed
    in another order, so at least 0.999 of labels agree."""
    x, sv, wt, epi = _inputs(ncls, fp, 20 + ncls, 3, 34, 70, 64, cuda)
    before = head_kernel.LAUNCHES
    got = head_kernel.blocked_head_argmax(x, sv, wt, epi, ncls, fp=fp)
    torch.cuda.synchronize()
    assert head_kernel.LAUNCHES == before + 1
    assert head_kernel.LAST_ROUTE == "mma"
    want = head_kernel._blocked_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    assert got.shape == (3, 68, 140) and got.dtype == torch.int32
    if fp:
        assert (got == want).float().mean().item() >= 0.999
    else:
        assert torch.equal(got, want)


def _check_mma_case(dev, ncls, fp, seed, b, h, w, c4):
    x, sv, wt, epi = _inputs(ncls, fp, seed, b, h, w, c4, dev)
    before = head_kernel.LAUNCHES
    got = head_kernel.blocked_head_argmax(x, sv, wt, epi, ncls, fp=fp)
    torch.cuda.synchronize()
    assert head_kernel.LAUNCHES == before + 1
    assert head_kernel.LAST_ROUTE == "mma"
    want = head_kernel._blocked_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    assert got.shape == (b, 2 * h, 2 * w) and got.dtype == torch.int32
    if fp:
        assert (got == want).float().mean().item() >= 0.999
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("c4", [16, 32, 48, 256, 320, 512])
def test_head_kernel_mma_tiling_edges(cuda, c4, ncls, fp):
    """The mma route at the edges of its tiling: a ragged k-group (C4 = 16,
    32, 48), one full register chunk (256, the serving width), two chunks
    with a ragged last one (320) and two full ones (512); 2*9*13 = 234
    pixels, not a
    multiple of the 16-pixel tile. int8 head bit-equal, fp head >= 0.999."""
    _check_mma_case(cuda, ncls, fp, 100 * ncls + c4, 2, 9, 13, c4)


@pytest.mark.cuda
@pytest.mark.parametrize("fp", [True, False])
def test_head_kernel_mma_serving_width(cuda, fp):
    """The serving width (C4 = 256, ncls = 2) at a small b, h, w whose
    widths are not multiples of 16 (3*40*37 = 4440 pixels)."""
    _check_mma_case(cuda, 2, fp, 11, 3, 40, 37, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_head_kernel_fp_edge(cuda, xdtype):
    """An fp edge into the head (bf16/f32 activations, sv None) takes the
    general route."""
    x, _, wt, epi = _inputs(2, True, 7, 2, 16, 24, 32, cuda)
    xf = (x.float() * 0.05).to(xdtype)
    got = head_kernel.blocked_head_argmax(xf, None, wt, epi, 2, fp=True)
    torch.cuda.synchronize()
    assert head_kernel.LAST_ROUTE == "general"
    ones = torch.ones(32, device=cuda)
    want = head_kernel._blocked_head_argmax_plain(xf, ones, wt, epi, 2, True)
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("ncls", [2, 5])
def test_head_kernel_f32_weight_takes_general_route(cuda, ncls):
    """An f32 weight (products the tensor cores cannot form exactly) takes
    the general route, with int8 activations."""
    x, sv, wt, epi = _inputs(ncls, True, 30 + ncls, 2, 9, 13, 64, cuda)
    wt = wt.float()
    got = head_kernel.blocked_head_argmax(x, sv, wt, epi, ncls, fp=True)
    torch.cuda.synchronize()
    assert head_kernel.LAST_ROUTE == "general"
    want = head_kernel._blocked_head_argmax_plain(x, sv, wt, epi, ncls, True)
    assert (got == want).float().mean().item() >= 0.999


@pytest.mark.cuda
def test_head_kernel_rejects_bad_inputs(cuda):
    x, sv, wt, epi = _inputs(2, False, 3, 1, 4, 4, 32, cuda)
    with pytest.raises(TypeError):
        head_kernel.blocked_head_argmax(x, sv, wt.float(), epi, 2, fp=False)
    with pytest.raises(ValueError):
        head_kernel.blocked_head_argmax(x[..., :24].contiguous(), sv[:24], wt[:, :24].contiguous(),
                                        epi, 2, fp=False)
    with pytest.raises(ValueError):
        head_kernel.blocked_head_argmax(x, sv, wt, epi, 9, fp=False)


# --- K1: the row shear (tpuseg_torch/csrc/shear_rows.cu) --------------------

def _shear_inputs(n, h, wp, w, seed, dev, shifts=None):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(0, 1, (n, h, wp)).astype(np.float32)).to(dev)
    if shifts is None:
        shifts = rng.integers(0, wp - w, (n, h))
    shift = torch.from_numpy(np.asarray(shifts, np.int32).reshape(n, h)).to(dev)
    frac = torch.from_numpy(rng.random((n, h)).astype(np.float32)).to(dev)
    return img, shift, frac


@pytest.mark.cuda
@pytest.mark.parametrize("n, h, wp, w", [
    (2, 32, 64, 40),     # the CPU tests' shape class
    (3, 7, 50, 37),      # W not a multiple of 4 or 32, H not a multiple of 8
    (1, 1, 300, 129),    # N = 1, H = 1, W past one warp pass
    (16, 64, 880, 512),  # the training shape's row width
])
def test_shear_kernel_bit_equal_to_plain(cuda, n, h, wp, w):
    from tpuseg_torch.ops import warp

    img, shift, frac = _shear_inputs(n, h, wp, w, n * 100 + h, cuda)
    before = warp.LAUNCHES
    got = warp._shear_rows(img, shift, frac, w)
    torch.cuda.synchronize()
    assert warp.LAUNCHES == before + 1
    want = warp._shear_rows_plain(img, shift, frac, w)
    assert got.shape == (n, h, w) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_shear_kernel_clip_ends(cuda):
    """Shifts at both ends of the clip range (0 and Wp-W-1), and beyond it
    (the kernel clamps as the plain version does)."""
    from tpuseg_torch.ops import warp

    n, h, wp, w = 2, 6, 45, 30
    shifts = [0, wp - w - 1, 0, wp - w - 1, -5, wp] * 2
    img, shift, frac = _shear_inputs(n, h, wp, w, 5, cuda, shifts)
    got = warp._shear_rows(img, shift, frac, w)
    assert torch.equal(got, warp._shear_rows_plain(img, shift, frac, w))
    # at shift 0 the first output column blends padded columns 0 and 1
    f = frac[0, 0]
    assert torch.equal(got[0, 0, 0], img[0, 0, 0] * (1 - f) + img[0, 0, 1] * f)


@pytest.mark.cuda
def test_shear_kernel_rejects_bad_inputs(cuda):
    from tpuseg_torch.ops import warp

    img, shift, frac = _shear_inputs(2, 4, 40, 20, 1, cuda)
    with pytest.raises(TypeError):
        warp._shear_rows(img.double(), shift, frac, 20)
    with pytest.raises(TypeError):
        warp._shear_rows(img, shift.long(), frac, 20)
    with pytest.raises(ValueError):
        warp._shear_rows(img, shift[:, :3], frac, 20)
    with pytest.raises(ValueError):
        warp._shear_rows(img, shift, frac, 40)  # no room for the +1 tap
    with pytest.raises(ValueError):
        warp._shear_rows(img, shift.cpu(), frac, 20)
    with pytest.raises(ValueError):
        warp._shear_rows(img.transpose(1, 2).contiguous().transpose(1, 2), shift, frac, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("h, w", [(64, 64), (48, 64)])
def test_augment_on_card_matches_cpu(cuda, h, w):
    """A full augment_and_preprocess pass on the card (shears through K1)
    against the same draws on the CPU: images to atol 1e-4 after z-score,
    masks on >= 0.999 of pixels (round of an interpolated 0.5 can flip)."""
    from tpuseg_torch.aug import device as aug
    from tpuseg_torch.ops import warp

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(h + w)
    b, c = 4, 1
    imgs = torch.from_numpy(rng.integers(0, 4096, (b, h, w, c)).astype(np.float32))
    msks = torch.from_numpy((rng.random((b, h, w)) > 0.5).astype(np.uint8))
    p = aug.DeviceAugmentParams(intensity_severity=0.1)
    draws = aug.draw_augmentation(torch.Generator().manual_seed(3), b, h, w, c, p)
    ci, cm = aug.apply_augmentation(imgs, msks, draws, p)
    want_img, want_lbl = aug.preprocess(ci, cm.to(torch.int32), 2)
    before = warp.LAUNCHES
    gi, gm = aug.apply_augmentation(imgs.to(cuda), msks.to(cuda), draws.to(cuda), p)
    got_img, got_lbl = aug.preprocess(gi, gm.to(torch.int32), 2)
    torch.cuda.synchronize()
    assert warp.LAUNCHES == before + 3  # x, y and x shears
    np.testing.assert_allclose(got_img.cpu().numpy(), want_img.numpy(), rtol=0, atol=1e-4)
    agree = (got_lbl.cpu() == want_lbl).all(-1).float().mean().item()
    assert agree >= 0.999, agree


@pytest.mark.cuda
def test_prefetch_to_card_widens_and_orders(cuda):
    from tpuseg_torch.train.prefetch import device_prefetch

    batches = [(np.full((2, 64, 64, 1), 65535 - i, np.uint16),
                np.full((2, 64, 64), i % 2, np.uint8)) for i in range(12)]
    for i, (img, msk) in enumerate(device_prefetch(iter(batches), cuda, depth=3)):
        assert img.device.type == "cuda" and img.dtype == torch.int32
        assert int(img.sum().item()) == (65535 - i) * img.numel()
        assert int(msk.sum().item()) == (i % 2) * msk.numel()
