"""Tests that need the card: the CUDA kernels against their plain PyTorch
versions. They skip without an NVIDIA card (a CUDA kernel has no CPU mode).
At the main path's shapes they call ``chip_smoke.py``'s checks, the ones
its kernel phases run before they time each kernel.

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os
import sys

import numpy as np
import pytest
import torch

from tpuseg_torch.infer import head_kernel
from tpuseg_torch.infer import input_conv as k5
from tpuseg_torch.infer import int8_conv as k3
from tpuseg_torch.ops import batchnorm as k4

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402


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
@pytest.mark.parametrize("fp", [True, False])
def test_head_kernel_at_the_serving_shape(cuda, fp):
    smoke.k2_check(fp, *smoke.head_inputs(fp, 0, cuda))


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


# --- K6: the dense head + argmax (csrc/head_argmax.cu, dense layout) -------

def _dense_inputs(ncls, fp, seed, b, h, w, c, dev, wt_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, c)).astype(np.int8)).to(dev)
    sv = torch.from_numpy(rng.uniform(0.01, 0.1, (c,)).astype(np.float32)).to(dev)
    epi = rng.normal(0, 0.3, (4, ncls)).astype(np.float32)
    epi[1] = rng.uniform(0.5, 1.5, ncls)
    if fp:
        wt = torch.from_numpy(rng.normal(0, 0.3, (ncls, c)).astype(np.float32)).to(wt_dtype)
        epi[3] = 1.0
    else:
        wt = torch.from_numpy(rng.integers(-127, 128, (ncls, c)).astype(np.int8))
        epi[3] = rng.uniform(1e-4, 1e-3, ncls)
    return x, sv, wt.to(dev), torch.from_numpy(epi).to(dev)


# (B, H, W, C): B*H*W of every residue mod 4 (the last row of four pixels
# partly filled), C from one 16-channel piece to K6's register/shared
# weight switch (4C > 256) and a ragged 64-channel group (48)
_DENSE_SHAPES = [(3, 17, 23, 64), (1, 5, 7, 16), (2, 33, 31, 48), (1, 1, 1, 64),
                 (1, 3, 1, 320), (4, 30, 30, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fp_mma", "int8_mma", "fp_general"])
@pytest.mark.parametrize("ncls", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("shape", _DENSE_SHAPES)
def test_dense_head_kernel_matches_plain(cuda, shape, ncls, variant):
    """K6 against its plain version: the int8 head bit-equal; the fp head
    (the same exact products summed in another order) on >= 0.999 of
    labels. An f32 weight takes the general route."""
    fp = variant != "int8_mma"
    wt_dtype = torch.float32 if variant == "fp_general" else torch.bfloat16
    x, sv, wt, epi = _dense_inputs(ncls, fp, 40 + ncls, *shape, cuda, wt_dtype)
    before = head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES
    got = head_kernel.dense_head_argmax(x, sv, wt, epi, ncls, fp=fp)
    torch.cuda.synchronize()
    assert (head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES) == (before[0] + 1, before[1])
    assert head_kernel.LAST_ROUTE == variant.split("_")[1]
    want = head_kernel._dense_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    assert got.shape == shape[:3] and got.dtype == torch.int32
    if fp:
        assert (got == want).float().mean().item() >= 0.999
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fp", [True, False])
def test_dense_head_kernel_at_the_dense_walk_shape(cuda, fp):
    x, sv, wt, epi = smoke.dense_head_inputs(fp, 0, cuda)
    op = None if fp else k3.Int8ConvWeights(np.ascontiguousarray(wt.cpu().numpy().T[None, None]))
    smoke.k6_check(fp, x, sv, wt, epi, op)


@pytest.mark.cuda
def test_dense_head_kernel_rejects_bad_inputs(cuda):
    x, sv, wt, epi = _dense_inputs(2, False, 3, 1, 4, 4, 32, cuda)
    before = head_kernel.DENSE_LAUNCHES
    with pytest.raises(TypeError):
        head_kernel.dense_head_argmax(x, sv, wt.float(), epi, 2, fp=False)
    with pytest.raises(ValueError, match="C % 16"):
        head_kernel.dense_head_argmax(x[..., :24].contiguous(), sv[:24],
                                      wt[:, :24].contiguous(), epi, 2, fp=False)
    with pytest.raises(ValueError, match="contiguous"):
        head_kernel.dense_head_argmax(x.transpose(1, 2), sv, wt, epi, 2, fp=False)
    misaligned = torch.zeros(4 * 32 + 1, dtype=torch.int8, device=cuda)[1:].view(1, 1, 4, 32)
    with pytest.raises(ValueError, match="aligned"):
        head_kernel.dense_head_argmax(misaligned, sv, wt, epi, 2, fp=False)
    assert head_kernel.DENSE_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("fp_blocks", [("enc1a", "head"), ("enc1a",)])
def test_dense_walk_runs_k6_once_a_predict_call(cuda, fp_blocks):
    """A base-16 int8 predict call on the card (the dense head's C = 16)
    runs its head through K6 once, fp or int8, never K2, and labels like
    the CPU walk on >= 0.999 (the fp head sums in another order)."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.models.unet import UNet, init_unet

    model = init_unet(UNet(2, 1, 16, torch.float32), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(6).normal(0, 1, (2, 64, 48, 1))
                         .astype(np.float32))
    folded = quant.fold_variables(model)
    fn = quant.make_quantized_predict_fn(
        folded, quant.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu"),
        fp_blocks=fp_blocks)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = fn(x)
        before = head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES
        got = fn(x.to(cuda)).cpu()
    assert (head_kernel.DENSE_LAUNCHES, head_kernel.LAUNCHES) == (before[0] + 1, before[1])
    assert head_kernel.LAST_ROUTE == "mma"
    assert got.shape == (2, 64, 48) and got.dtype == torch.int32
    assert (got == want).float().mean().item() >= 0.999


# --- K3: the int8 conv with its epilogue fused (csrc/int8_conv.cu) ---------

K3_MODES = ["relu_requant", "relu_f32", "affine_requant"]


def _k3_inputs(cin, cout, k, b, h, w, mode, seed, dev):
    """Random codes and per-channel vectors that put f(acc) * ws near
    N(0, 1), so the requantized codes are spread over the range."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)).to(dev)
    wq = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    ws = rng.uniform(0.5, 1.5, cout) / (np.sqrt(k * k * cin) * 5461.0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    epi = k3.Epilogue(mode, t(ws),
                      None if mode == "affine_requant" else t(rng.normal(0, 0.3, cout)),
                      t(rng.uniform(0.5, 1.5, cout)), t(rng.normal(0, 0.3, cout)),
                      None if mode == "relu_f32" else t(np.float32(2.0 / 127.0)))
    return x, k3.Int8ConvWeights(wq), epi


def _k3_check(dev, cin, cout, k, b, h, w, mode, seed):
    x, op, epi = _k3_inputs(cin, cout, k, b, h, w, mode, seed, dev)
    before = k3.LAUNCHES
    got = k3.int8_conv(x, op, epi)
    assert k3.LAUNCHES == before + 1
    want = k3._int8_conv_plain(x, op, epi)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape == (b, h, w, cout)
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("cout", [2, 5, 64, 256, 2048])
@pytest.mark.parametrize("cin", [1, 3, 4, 64, 256, 512])
def test_int8_conv_kernel_bit_equal_to_plain(cuda, cin, cout, k, mode):
    seed = cin + 3 * cout + k
    _k3_check(cuda, cin, cout, k, 1 + seed % 3, 9, 13, mode, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("cin, cout, k, b, h, w", [
    (16, 24, 3, 2, 37, 45), (48, 130, 3, 1, 33, 17), (80, 128, 1, 3, 31, 29),
    (128, 256, 3, 1, 64, 64), (4, 64, 3, 2, 40, 24), (1, 64, 3, 1, 35, 33)])
def test_int8_conv_kernel_many_tiles(cuda, cin, cout, k, b, h, w, mode):
    """Many M tiles with an M tail, N tails past 128, Cin past one K-step."""
    _k3_check(cuda, cin, cout, k, b, h, w, mode, cin + cout + h)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relu_requant", "affine_requant"])
def test_int8_conv_kernel_codes_span_the_range(cuda, mode):
    got = _k3_check(cuda, 64, 256, 3, 2, 24, 24, mode, 11)
    codes = torch.unique(got)
    # the ReLU keeps the negative codes to those of negative shifts t
    assert codes.numel() >= (150 if mode == "relu_requant" else 200)
    assert codes.max().item() == 127 and (mode == "relu_requant" or codes.min().item() == -127)
    assert (got.abs() == 127).float().mean().item() < 0.5


@pytest.mark.cuda
def test_int8_conv_kernel_rejects_bad_inputs(cuda):
    x, op, epi = _k3_inputs(32, 8, 3, 1, 6, 6, "relu_requant", 0, cuda)
    before = k3.LAUNCHES
    with pytest.raises(TypeError):
        k3.int8_conv(x.float(), op, epi)
    with pytest.raises(ValueError, match="contiguous"):
        k3.int8_conv(x.transpose(1, 2), op, epi)
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(x.numel() + 1, dtype=torch.int8, device=cuda)
        k3.int8_conv(buf[1:].view(x.shape), op, epi)
    with pytest.raises(ValueError, match="channels"):
        k3.int8_conv(x[..., :16].contiguous(), op, epi)
    with pytest.raises(ValueError, match="float32"):
        k3.int8_conv(x, op, k3.Epilogue(epi.mode, epi.ws.cpu(), epi.b, epi.s, epi.t, epi.so))
    with pytest.raises(ValueError, match="shape"):
        k3.int8_conv(x, op, k3.Epilogue(epi.mode, epi.ws[:4], epi.b, epi.s, epi.t, epi.so))
    with pytest.raises(ValueError, match="scalar"):
        k3.int8_conv(x, op, k3.Epilogue(epi.mode, epi.ws, epi.b, epi.s, epi.t, epi.ws))
    with pytest.raises(ValueError, match="5x5"):
        k3.int8_conv(x, k3.Int8ConvWeights(np.zeros((5, 5, 32, 8), np.int8)), epi)
    assert k3.LAUNCHES == before


def _k3_route_check(dev, x, op, epi, route, bn=None):
    before = dict(k3.ROUTE_LAUNCHES)
    got = k3._launch(x, op, epi, route=route, bn=bn)
    assert k3.LAST_ROUTE == route and k3.ROUTE_LAUNCHES[route] == before[route] + 1
    want = k3._int8_conv_plain(x, op, epi)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def _k3_blocked_inputs(groups, b, h, w, mode, seed, dev):
    """Codes blocked as the int8_blocked walk's edge convs are (3/4 of them
    structural zeros), ws scaled by the fan-in of the non-zero taps."""
    from tpuseg_torch.infer.quant import _block_weight

    rng = np.random.default_rng(seed)
    c0 = sum(groups)
    cout = 4 * 64
    x = torch.from_numpy(rng.integers(-127, 128, (b, h, w, 4 * c0)).astype(np.int8)).to(dev)
    w0 = rng.integers(-127, 128, (3, 3, c0, cout // 4)).astype(np.float32)
    wq = _block_weight(w0, groups).astype(np.int8)
    ws = rng.uniform(0.5, 1.5, cout) / (np.sqrt(9 * c0) * 5461.0)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    epi = k3.Epilogue(mode, t(ws),
                      None if mode == "affine_requant" else t(rng.normal(0, 0.3, cout)),
                      t(rng.uniform(0.5, 1.5, cout)), t(rng.normal(0, 0.3, cout)),
                      None if mode == "relu_f32" else t(np.float32(2.0 / 127.0)))
    return x, k3.Int8ConvWeights(wq), epi


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("cout", [2, 5, 64, 128, 256, 2048])
@pytest.mark.parametrize("cin", [16, 48, 64, 80, 512])
def test_int8_conv_wgmma_route_bit_equal(cuda, cin, cout, mode):
    """The wgmma route at the N-tile width its rule picks; W in {16, 64,
    100, 512} across the cases, H = 13 (no multiple of any patch height
    past 1), 1x1 where Cin is 512."""
    w = (16, 64, 100, 512)[(cin // 16 + cout) % 4]
    k = 1 if cin == 512 else 3
    x, op, epi = _k3_inputs(cin, cout, k, 2, 13, w, mode, cin + cout + w, cuda)
    _k3_route_check(cuda, x, op, epi, "wgmma")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("cin, w", [(80, 100), (48, 16), (16, 64)])
def test_int8_conv_wgmma_every_tile_width(cuda, cin, w, bn, mode):
    """Every N-tile width, with an N tail (Cout 130) and a Cin tail."""
    x, op, epi = _k3_inputs(cin, 130, 3, 1, 21, w, mode, bn + cin, cuda)
    _k3_route_check(cuda, x, op, epi, "wgmma", bn)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("route", ["wgmma", "mma"])
@pytest.mark.parametrize("groups", [(16,), (16, 16), (64,), (64, 64)])
def test_int8_conv_blocked_weights_skip_zero_k_steps(cuda, groups, route, mode):
    """Blocked weights run only their non-zero K-steps (a quarter per
    output phase), on both routes."""
    x, op, epi = _k3_blocked_inputs(groups, 2, 13, 100, mode, sum(groups) + len(groups), cuda)
    if groups[0] == 64:  # a K-step is one input phase of a group: 9 of 36 per phase
        assert (op.kernel(cuda).host_counts[64] == 9 * len(groups)).all()
    _k3_route_check(cuda, x, op, epi, route)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K3_MODES)
@pytest.mark.parametrize("route, bn", [("wgmma", 64), ("wgmma", 128), ("wgmma", 256),
                                       ("mma", 128)])
def test_int8_conv_empty_skip_list(cuda, route, bn, mode):
    """Output channels 128.. have all-zero weights: their N tiles run no
    K-step and store the epilogue of zero sums."""
    x, op, epi = _k3_inputs(64, 300, 3, 1, 13, 64, mode, 5, cuda)
    wq = op._wq.copy()
    wq[..., 128:] = 0
    op = k3.Int8ConvWeights(wq)
    counts = op.kernel(cuda).host_counts[bn]
    assert counts[-1] == 0
    _k3_route_check(cuda, x, op, epi, route, bn)


_K3_WALK_BLOCKS = smoke.k3_blocks() + smoke.K3_DENSE_FORM_BLOCKS


@pytest.mark.cuda
@pytest.mark.parametrize("block", _K3_WALK_BLOCKS, ids=[b[0] for b in _K3_WALK_BLOCKS])
def test_int8_conv_at_the_walks_block_shapes(cuda, block):
    """Each block of a predict call, and the dense walk's two form blocks,
    through both routes and in its store forms."""
    name, shape, k, cout, mode = block
    x, op, epi = smoke.k3_inputs(name, shape, k, cout, mode, 0, cuda)
    smoke.k3_check(name, x, op, epi)
    form = smoke.k3_form(name, cout)
    if form is not None:
        smoke.k3_form_check(name, x, op, epi, form, 1, cuda)


@pytest.mark.cuda
def test_int8_conv_route_rule_and_refusals(cuda):
    """Cin % 16 != 0 takes the mma route; the wgmma route, an N tile the
    route does not take and an unknown route raise and launch nothing."""
    x, op, epi = _k3_inputs(4, 64, 3, 1, 9, 13, "relu_requant", 1, cuda)
    k3.int8_conv(x, op, epi)
    assert k3.LAST_ROUTE == "mma"
    x16, op16, epi16 = _k3_inputs(16, 64, 3, 1, 9, 13, "relu_requant", 2, cuda)
    k3.int8_conv(x16, op16, epi16)
    assert k3.LAST_ROUTE == "wgmma"
    before = k3.LAUNCHES
    with pytest.raises(ValueError, match="Cin % 16"):
        k3._launch(x, op, epi, route="wgmma")
    with pytest.raises(ValueError, match="N tile"):
        k3._launch(x16, op16, epi16, route="mma", bn=64)
    with pytest.raises(ValueError, match="N tile"):
        k3._launch(x16, op16, epi16, route="wgmma", bn=32)
    with pytest.raises(ValueError, match="route"):
        k3._launch(x16, op16, epi16, route="dense")
    assert k3.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_int8_walk_launches_k3_per_block(cuda, blocked):
    """A base-4 int8 predict call on the card launches K3 once per int8
    block (21 with the default fp_blocks) and labels like the CPU walk
    (>= 0.999: the fp head sums in another order on the card)."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.models.unet import UNet, init_unet

    model = init_unet(UNet(2, 1, 4, torch.float32), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, 64, 48, 1))
                         .astype(np.float32))
    folded = quant.fold_variables(model)
    fn = quant.make_quantized_predict_fn(
        folded, quant.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu"),
        blocked_edges=blocked)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        before = k3.LAUNCHES
        want = fn(x)
        assert k3.LAUNCHES == before
        got = fn(x.to(cuda)).cpu()
    assert k3.LAUNCHES == before + 21
    assert (got == want).float().mean().item() >= 0.999


# --- K3's store forms: the int8 walks' concats, depth-to-space and pools ----

def _k3_form_check(dev, x, op, epi, around, d2s, pool, seed, **launch):
    """K3 with its store forms against the plain version's, from the same
    concat buffer (its other channels random codes, ``around`` = channels
    before and after the output's; None: no ``out``): the whole buffer and
    the pooled codes equal."""
    b, h, w, _ = x.shape
    c = op.cout // 4 if d2s else op.cout
    oh, ow = (2 * h, 2 * w) if d2s else (h, w)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = out_plain = buf = buf_plain = None
    if around is not None:
        buf = torch.randint(-127, 128, (b, oh, ow, c + sum(around)), generator=g, device=dev,
                            dtype=torch.int8)
        buf_plain = buf.clone()
        out = buf[..., around[0]:around[0] + c]
        out_plain = buf_plain[..., around[0]:around[0] + c]
    before = k3.LAUNCHES
    got = k3._launch(x, op, epi, out=out, d2s=d2s, pool=pool, **launch)
    assert k3.LAUNCHES == before + 1 and k3.LAST_ROUTE == "wgmma"
    want = k3._int8_conv_plain(x, op, epi, out_plain, d2s, pool)
    torch.cuda.synchronize()
    got, got_pool = got if pool else (got, None)
    want, want_pool = want if pool else (want, None)
    if buf is not None:
        assert got.data_ptr() == out.data_ptr()
        got, want = buf, buf_plain
    assert got.shape == want.shape and torch.equal(got, want), \
        (got.float() - want.float()).abs().max().item()
    if pool:
        assert got_pool.shape == want_pool.shape and torch.equal(got_pool, want_pool)
        assert torch.unique(want_pool).numel() >= 64
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("bw", [16, 32, 64])
@pytest.mark.parametrize("h, w", [(14, 22), (64, 64), (6, 130)])
def test_int8_conv_spatial_pool_store(cuda, h, w, bw, bn):
    """A skip's producer: codes into channels [0, 160) of a 192-wide
    concat buffer and the 2x2 max beside them, at every N-tile width (Cout
    160: a ragged last N tile) and pooled patch width, with patch rows and
    columns past H and W masked."""
    x, op, epi = _k3_inputs(64, 160, 3, 2, h, w, "relu_requant", h + w + bw + bn, cuda)
    _k3_form_check(cuda, x, op, epi, (0, 32), False, "spatial", bw, bn=bn, bw=bw)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("bw", [16, 32, 64, 128])
@pytest.mark.parametrize("cin, c", [(128, 64), (64, 16), (512, 256)])
def test_int8_conv_d2s_store(cuda, cin, c, bw, bn):
    """A deconv: depth-to-space on store into the channels [C, 2C) of its
    concat buffer (C 64 as the dense dec1up, 16, and 256), every N-tile and
    patch width, H and W ragged against every patch."""
    x, op, epi = _k3_inputs(cin, 4 * c, 1, 2, 13, 21, "affine_requant", cin + c + bw, cuda)
    _k3_form_check(cuda, x, op, epi, (c, 0), True, None, bn, bn=bn, bw=bw)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 256])
@pytest.mark.parametrize("bw", [16, 32, 64, 128])
@pytest.mark.parametrize("h, w", [(13, 100), (32, 48)])
def test_int8_conv_phase_pool_store_blocked_enc1b(cuda, h, w, bw, bn):
    """The blocked enc1b: blocked weights (3/4 structural zeros), codes into
    channels [0, 256) of dec1a's 512-wide buffer and the max over the four
    phase groups beside them: 4 N tiles of 64, one phase each, in one block
    (the rule's width), and one N tile of 256."""
    x, op, epi = _k3_blocked_inputs((64,), 2, h, w, "relu_requant", h + bw, cuda)
    assert k3.n_tile_width("wgmma", 256, op.kernel(cuda).host_counts, "phase") == 64
    _k3_form_check(cuda, x, op, epi, (0, 256), False, "phase", bw, bw=bw, bn=bn)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relu_requant", "affine_requant"])
@pytest.mark.parametrize("h, w", [(11, 37), (16, 130)])
def test_int8_conv_phase_pool_store_one_phase_a_tile(cuda, h, w, mode):
    """Dense codes (every K-step in every tile) with a phase max over 4 N
    tiles of 64, one phase each, without ``out``; H and W ragged against
    the patch."""
    x, op, epi = _k3_inputs(48, 256, 3, 2, h, w, mode, h + w, cuda)
    _k3_form_check(cuda, x, op, epi, None, False, "phase", h, bn=64)


@pytest.mark.cuda
@pytest.mark.parametrize("bn", [64, 128, 256])
def test_int8_conv_phase_pool_store_narrow(cuda, bn):
    """A phase max of Cout 64 (F 16) at every N-tile width that covers it,
    without ``out``."""
    x, op, epi = _k3_inputs(32, 64, 3, 1, 9, 40, "relu_requant", bn, cuda)
    _k3_form_check(cuda, x, op, epi, None, False, "phase", bn, bn=bn)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["relu_requant", "affine_requant"])
@pytest.mark.parametrize("bn", [64, 128, 256])
@pytest.mark.parametrize("around", [(0, 32), (48, 0), (16, 16)])
def test_int8_conv_concat_store(cuda, around, bn, mode):
    """``out=`` alone at offsets 0, 48 and 16 of a wider buffer (the
    blocked dec1up's form), a ragged N tile (Cout 80), masked patch rows
    (H 21 against the wrapper's patch)."""
    x, op, epi = _k3_inputs(48, 80, 3, 2, 21, 37, mode, sum(around) + bn, cuda)
    _k3_form_check(cuda, x, op, epi, around, False, None, bn, bn=bn)


@pytest.mark.cuda
def test_int8_conv_forms_refused_on_the_card(cuda):
    """What the kernel does not store raises on a CUDA tensor and launches
    nothing: the mma route (Cin % 16), 16-byte segments (Cout, the buffer,
    a phase), a misaligned ``out``, a phase max that no N tile takes, a
    spatial pool on 128 x 1 patches, the f32 mode."""
    x, op, epi = _k3_inputs(64, 64, 3, 1, 8, 8, "relu_requant", 0, cuda)
    x4, op4, epi4 = _k3_inputs(4, 64, 3, 1, 8, 8, "relu_requant", 1, cuda)
    x24, op24, epi24 = _k3_inputs(64, 24, 3, 1, 8, 8, "relu_requant", 2, cuda)
    x1024, op1024, epi1024 = _k3_inputs(64, 1024, 1, 1, 8, 8, "relu_requant", 3, cuda)
    buf = torch.zeros((1, 8, 8, 128), dtype=torch.int8, device=cuda)
    f32 = k3.Epilogue("relu_f32", epi.ws, epi.b, epi.s, epi.t, None)
    before = k3.LAUNCHES
    with pytest.raises(ValueError, match="wgmma"):
        k3.int8_conv(x4, op4, epi4, pool="spatial")
    with pytest.raises(ValueError, match="wgmma"):
        k3._launch(x, op, epi, route="mma", out=buf[..., :64])
    with pytest.raises(ValueError, match="16-byte"):
        k3.int8_conv(x24, op24, epi24, pool="spatial")
    with pytest.raises(ValueError, match="16-byte"):
        k3.int8_conv(x, op, epi, out=torch.zeros((1, 8, 8, 72), dtype=torch.int8,
                                                 device=cuda)[..., :64])
    with pytest.raises(ValueError, match="aligned"):
        k3.int8_conv(x, op, epi, out=buf[..., 8:72])
    with pytest.raises(ValueError, match="N tile"):
        k3.int8_conv(x1024, op1024, epi1024, pool="phase")
    with pytest.raises(ValueError, match="N tile"):
        k3._launch(x, k3.Int8ConvWeights(np.zeros((3, 3, 64, 256), np.int8)),
                   _k3_inputs(64, 256, 3, 1, 8, 8, "relu_requant", 4, cuda)[2], bn=128,
                   pool="phase")
    with pytest.raises(ValueError, match="even row count"):
        k3._launch(x, op, epi, pool="spatial", bw=128)
    with pytest.raises(ValueError, match="int8 modes"):
        k3.int8_conv(x, op, f32, out=buf[..., :64])
    assert k3.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_int8_walks_take_the_store_forms(cuda, blocked):
    """A base-16 int8 predict call on the card (every channel count a
    multiple of 16) makes 8 of its 21 K3 launches with store forms (4
    skips into their concat buffers with their pools, 4 deconvs into the
    other halves), and labels like the CPU walk (>= 0.999: the fp head
    sums in another order on the card)."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.models.unet import UNet, init_unet

    model = init_unet(UNet(2, 1, 16, torch.float32), torch.Generator().manual_seed(1)).eval()
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 64, 48, 1))
                         .astype(np.float32))
    folded = quant.fold_variables(model)
    fn = quant.make_quantized_predict_fn(
        folded, quant.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu"),
        blocked_edges=blocked)
    forms, launch = [], k3._launch

    def counted(x, weights, epilogue, out=None, d2s=False, pool=None, **kw):
        forms.append((out is not None, d2s, pool))
        return launch(x, weights, epilogue, out=out, d2s=d2s, pool=pool, **kw)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = fn(x)
        k3._launch = counted
        try:
            got = fn(x.to(cuda)).cpu()
        finally:
            k3._launch = launch
    pools = ["phase"] + ["spatial"] * 3 if blocked else ["spatial"] * 4
    assert len(forms) == 21
    assert [f for f in forms if f[2]] == [(True, False, p) for p in pools]
    assert [f for f in forms if f[0] and not f[2]] == \
        [(True, True, None)] * 3 + [(True, not blocked, None)]
    assert (got == want).float().mean().item() >= 0.999


# --- K5: the fp input conv with its epilogue fused (csrc/input_conv.cu) -----

def _k5_inputs(b, h, w, c, f, seed, dev):
    """A z-scored batch, a kernel, epilogue vectors and an output scale that
    spread the codes over the int8 range, as card tensors."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(0, 1, (b, h, w, c)), rng.normal(0, 1, (3, 3, c, f)) / np.sqrt(9 * c),
              rng.normal(0, 0.3, f), rng.uniform(0.5, 1.5, f), rng.normal(0, 0.3, f),
              np.asarray(2.5 / 127.0)]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in arrays]


def _k5_check(dev, b, h, w, c, f, blocked, dtype=torch.bfloat16, seed=0):
    args = _k5_inputs(b, h, w, c, f, seed, dev)
    before = k5.LAUNCHES
    got = k5.input_conv(*args, dtype, blocked)
    torch.cuda.synchronize()
    assert k5.LAUNCHES == before + 1
    want = k5._input_conv_plain(*args, dtype, blocked)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("f", [4, 16, 64, 256])
@pytest.mark.parametrize("c", [1, 3])
def test_input_conv_kernel_bit_equal_to_plain(cuda, c, f, blocked):
    """34 x 70 images: the last row and column of tiles cut short (9 x 1
    tiles of 4 x 128 at C 1, 5 x 3 of 8 x 32 at C 3)."""
    want = _k5_check(cuda, 2, 34, 70, c, f, blocked, seed=c * 1000 + f)
    assert torch.unique(want).numel() >= 64 and (want.abs() == 127).float().mean() < 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_input_conv_kernel_f32_operands(cuda, c, blocked):
    """f32 operands: separate products and sums, no FMA."""
    _k5_check(cuda, 2, 34, 70, c, 64, blocked, torch.float32, seed=c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,blocked", [(1, 1, 1, False), (3, 1, 5, False), (2, 9, 33, False),
                                           (1, 2, 2, True), (5, 8, 32, True),
                                           (1, 18, 66, True), (8, 128, 96, True)])
def test_input_conv_kernel_image_edges(cuda, b, h, w, blocked):
    """Images smaller than a tile, exactly one tile, odd tile counts: the
    SAME zeros fall at every image edge."""
    _k5_check(cuda, b, h, w, 1, 64, blocked, seed=h * w)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 20, 40])
def test_input_conv_kernel_scalar_tail(cuda, f):
    """F % 16 != 0: byte stores, the last group of 16 cut short."""
    for blocked in (False, True):
        _k5_check(cuda, 2, 10, 36, 3, f, blocked, seed=f)


@pytest.mark.cuda
def test_input_conv_kernel_channel_chunks(cuda):
    """40 input channels, 128 output: two chunks of 80 and 48 channels
    (the weights of all 128 and two halo buffers overflow a block's shared
    memory)."""
    assert k5.launch_plan((1, 12, 40, 40), 128, torch.bfloat16, False, cuda)["fc"] == 80
    for blocked in (False, True):
        _k5_check(cuda, 1, 12, 40, 40, 128, blocked, seed=40)


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("b,h,w", [(1, 4, 128), (2, 512, 512)])
def test_input_conv_kernel_persistent_grid(cuda, b, h, w, blocked):
    """One tile (one block), and many more tiles than the card holds
    blocks (each block walks a run of them): the grid follows the rule."""
    plan = k5.launch_plan((b, h, w, 1), 64, torch.bfloat16, blocked, cuda)
    tiles = b * -(-h // 4) * -(-w // 128)
    assert (plan["fc"], plan["stages"], plan["staged"]) == (64, 2, True)
    assert plan["tiles"] == tiles and (plan["tile_h"], plan["tile_w"]) == (4, 128)
    assert plan["resident_per_sm"] >= 2  # 16 warps an SM at the served shape
    assert plan["grid"] == min(tiles, plan["sms"] * plan["resident_per_sm"])
    assert (plan["grid"] == 1) if tiles == 1 else (plan["grid"] < tiles)
    _k5_check(cuda, b, h, w, 1, 64, blocked, seed=b * h)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [4, 20, 64, 256])
@pytest.mark.parametrize("c", [1, 3, 100])
def test_input_conv_kernel_ragged_tiles(cuda, c, f, dtype):
    """H and W off the tile (dense W 37: at C 1 an input row of 148 bytes,
    not a multiple of 16), blocked widths of 3 tile columns (W 384 at C 1,
    96 at other C), every plan: staged codes (F 64; 256 at C 3), tails (F 4,
    20), chunks with one halo buffer (C 100)."""
    _k5_check(cuda, 2, 19, 37, c, f, False, dtype, seed=c * 100 + f)
    tw = k5.launch_plan((2, 18, 8, c), f, dtype, True, cuda)["tile_w"]
    _k5_check(cuda, 2, 18, 3 * tw, c, f, True, dtype, seed=c * 100 + f + 1)


@pytest.mark.cuda
def test_input_conv_chunk_width_rule(cuda):
    """The plan the library makes: all of F in one block, its codes staged
    for the bulk copy, where F % 16 == 0 and that fits (every served
    width); otherwise chunks of a multiple of 16 (at most 1024) where the
    weights would overflow shared memory, with two halo buffers where they
    fit, else with one; C 120 refused. Tiles of 4 x 128 at C 1, 8 x 32
    otherwise; the served shape fits three blocks an SM."""
    def plan(c, f):
        p = k5.launch_plan((2, 64, 256, c), f, torch.bfloat16, True, cuda)
        return p["fc"], p["stages"], p["staged"]

    assert [plan(1, f)[0] for f in (4, 16, 20, 64, 256)] == [16, 16, 32, 64, 256]
    assert plan(1, 64) == (64, 2, True) and plan(3, 64) == (64, 2, True)
    assert plan(3, 256) == (256, 2, True)
    assert plan(1, 256) == (256, 2, False)  # a 4 x 128 tile's codes would not fit
    assert plan(1, 20) == (32, 2, False)  # tail: F % 16 != 0
    assert plan(3, 1024) == (1024, 2, False) and plan(1, 2048)[0] == 1024
    assert plan(40, 128) == (80, 2, False)
    assert plan(70, 64)[1] == 2 and plan(71, 64)[1] == 1
    assert plan(100, 64) == (16, 1, False) and plan(119, 64) == (16, 1, False)
    with pytest.raises(RuntimeError, match="plan failed"):
        plan(120, 64)
    served = k5.launch_plan((8, 1024, 1024, 1), 64, torch.bfloat16, True, cuda)
    assert (served["tile_h"], served["tile_w"]) == (4, 128)
    assert served["smem_bytes"] == 4 * (2 * 6 * 136 + 9 * 64 + 3 * 64) + 2 * 4 * (128 * 64 + 32)
    assert served["resident_per_sm"] >= 3
    c3 = k5.launch_plan((8, 1024, 1024, 3), 64, torch.bfloat16, False, cuda)
    assert (c3["tile_h"], c3["tile_w"]) == (8, 32)
    x, w, b, s, t, so = _k5_inputs(1, 8, 8, 120, 16, 0, cuda)
    before = k5.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        k5.input_conv(x, w, b, s, t, so, torch.bfloat16)
    assert k5.LAUNCHES == before


@pytest.mark.cuda
def test_input_conv_requant_reciprocal_matches_true_division(cuda):
    """The kernel's reciprocal requantize gives __fdiv_rn's codes for random
    scales over its whole range (2^-64..2^64 and the bounds), on random
    values (NaNs and infinities among them) and values within 8 ulps of the
    rounding's ties; its quotients differ from __fdiv_rn's only in underflow
    (|v| < 2^-100 or a subnormal quotient), far below a code's 1/2."""
    rng = np.random.default_rng(9)
    so = np.concatenate([2.0 ** rng.uniform(-64, 64, 32), [2.5 / 127, 2.0 ** -64, 2.0 ** 64]])
    m = k5.requant_mismatches(torch.tensor(so, dtype=torch.float32, device=cuda),
                              count=1 << 20, seed=3)
    assert m["codes"] == 0, m["examples"]
    assert m["normal"] == 0 and m["largest_quotient"] < 2.0 ** -36, m


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2.0 ** -70, 2.0 ** 70, -1.0])
def test_input_conv_kernel_scales_outside_the_reciprocal_range(cuda, scale):
    """Output scales past 2^-64..2^64, or negative, take the true division:
    s, t and so scaled alike keep the codes spread, bit-equal in both
    layouts."""
    for blocked in (False, True):
        x, w, b, s, t, so = _k5_inputs(2, 34, 70, 1, 64, 11, cuda)
        args = [x, w, b, s * scale, t * scale, so * scale]
        got = k5.input_conv(*args, torch.bfloat16, blocked)
        want = k5._input_conv_plain(*args, torch.bfloat16, blocked)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.unique(want).numel() >= 64


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("c", [1, 3])
def test_input_conv_kernel_at_the_serving_shape(cuda, c, blocked):
    smoke.k5_check(smoke.k5_inputs(c, c, cuda), torch.bfloat16, blocked)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phase2_scale_every_value", "random_scales"])
def test_input_conv_requant_every_value_and_many_scales(cuda, case):
    so = smoke.k5_inputs(1, 1, cuda)[5]
    smoke.k5_division_check(*smoke.k5_division_cases(so, 0, cuda)[case])


@pytest.mark.cuda
def test_input_conv_kernel_back_to_back_shapes(cuda):
    """Two launches of different shapes and plans queued on one stream, no
    synchronisation between them."""
    a = _k5_inputs(2, 40, 64, 1, 64, 7, cuda)
    b = _k5_inputs(1, 19, 37, 3, 20, 8, cuda)
    got_a = k5.input_conv(*a, torch.bfloat16, True)
    got_b = k5.input_conv(*b, torch.float32, False)
    torch.cuda.synchronize()
    assert torch.equal(got_a, k5._input_conv_plain(*a, torch.bfloat16, True))
    assert torch.equal(got_b, k5._input_conv_plain(*b, torch.float32, False))


@pytest.mark.cuda
def test_input_conv_kernel_rejects_bad_inputs(cuda):
    x, w, b, s, t, so = _k5_inputs(1, 6, 6, 1, 16, 0, cuda)
    before = k5.LAUNCHES
    with pytest.raises(ValueError, match="rounds operands"):
        k5.input_conv(x, w, b, s, t, so, torch.float16)
    with pytest.raises(ValueError, match="float32"):
        k5.input_conv(x.double(), w, b, s, t, so, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        k5.input_conv(x.transpose(1, 2), w, b, s, t, so, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 on"):
        k5.input_conv(x, w, b.cpu(), s, t, so, torch.bfloat16)
    with pytest.raises(ValueError, match="HWIO"):
        k5.input_conv(x, w[:, :, :, :8].reshape(3, 3, 2, 4), b, s, t, so, torch.bfloat16)
    with pytest.raises(ValueError, match="even H and W"):
        k5.input_conv(x[:, :5].contiguous(), w, b, s, t, so, torch.bfloat16, blocked=True)
    assert k5.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("blocked", [False, True])
def test_int8_walk_runs_input_conv_once_a_predict_call(cuda, blocked):
    """A base-4 int8 predict call on the card runs enc1a through K5 once
    and labels like the CPU walk on >= 0.999 (the fp head sums in another
    order on the card)."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.models.unet import UNet, init_unet

    model = init_unet(UNet(2, 1, 4, torch.float32), torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 64, 48, 1))
                         .astype(np.float32))
    folded = quant.fold_variables(model)
    fn = quant.make_quantized_predict_fn(
        folded, quant.calibrate(folded, [x[0, ..., 0].numpy()], device="cpu"),
        blocked_edges=blocked)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = fn(x)
        before = k5.LAUNCHES
        got = fn(x.to(cuda)).cpu()
        assert k5.LAUNCHES == before + 1
        fn(x.to(cuda))
    assert k5.LAUNCHES == before + 2
    assert (got == want).float().mean().item() >= 0.999


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
def test_shear_kernel_at_the_training_shape(cuda):
    smoke.k1_check(*smoke.shear_inputs(0, cuda), smoke.SHEAR_W)


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


# --- streaming serving and metrics on the card -------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["none", "int8_blocked"])
def test_streaming_on_card_matches_cpu(cuda, tmp_path, quantize):
    """inference_tiled_streaming on the card against the same call on the
    CPU (a base-4 U-Net, f32 convs with TF32 off): >= 0.999 of labels
    agree; under int8_blocked K2 launches once per chunk of each zone row."""
    import copy

    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import quant, tiled
    from tpuseg_torch.models.unet import UNet, init_unet
    from tpuseg_torch.utils import bigtiff

    model = init_unet(UNet(2, 1, 4, torch.float32), torch.Generator().manual_seed(0)).eval()
    img = np.random.default_rng(8).integers(0, 4096, (640, 480)).astype(np.uint16)
    stats = zscore_stats(img)
    src = str(tmp_path / "slide.tif")
    bigtiff.write_bigtiff(src, img, tile=(128, 128))
    if quantize == "none":
        fns = {"cpu": tiled.make_predict_fn(model),
               "cuda": tiled.make_predict_fn(copy.deepcopy(model).to(cuda))}
    else:
        folded = quant.fold_variables(model)
        crop = (img[192:448, 112:368].astype(np.float32) - stats[0]) / stats[1]
        fn = quant.make_quantized_predict_fn(
            folded, quant.calibrate(folded, [crop], device="cpu"), blocked_edges=True)
        fns = {"cpu": fn, "cuda": fn}
    tile, radius, batch = 288, 96, 2
    out = {}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for dev in ("cpu", "cuda"):
            head_kernel.LAUNCHES = 0
            path = str(tmp_path / f"{dev}.tif")
            with bigtiff.BigTiffReader(src) as reader:
                tiled.inference_tiled_streaming(reader, fns[dev], path, tile, radius, batch,
                                                num_classes=2, norm_stats=stats,
                                                progress=False, device=dev)
            out[dev] = (bigtiff.read_bigtiff(path), head_kernel.LAUNCHES)
    (want, cpu_launches), (got, launches) = out["cpu"], out["cuda"]
    assert got.shape == want.shape == img.shape and got.dtype == np.uint8
    assert (got == want).mean() >= 0.999
    assert cpu_launches == 0
    zor = tile - 2 * radius
    n_rows, n_cols = -(-640 // zor), -(-480 // zor)
    assert launches == (n_rows * -(-n_cols // batch) if quantize == "int8_blocked" else 0)


@pytest.mark.cuda
def test_confusion_matrix_on_card_matches_host(cuda):
    from tpuseg_torch.ops import metrics

    rng = np.random.default_rng(2)
    pred = rng.integers(0, 4, (3, 130, 70)).astype(np.int64)
    true = rng.integers(0, 4, (3, 130, 70)).astype(np.int64)
    pred[rng.random(pred.shape) < 0.02] = 255
    true[rng.random(true.shape) < 0.02] = -1
    got = metrics.confusion_matrix(torch.from_numpy(pred).to(cuda),
                                   torch.from_numpy(true).to(cuda), 4)
    assert got.device.type == "cuda" and got.dtype == torch.int32
    np.testing.assert_array_equal(got.cpu().numpy(), metrics._bincount_cm(pred, true, 4))
    m = metrics.segmentation_metrics(torch.from_numpy(pred).to(cuda),
                                     torch.from_numpy(true).to(cuda), 4)
    assert torch.equal(m["confusion"], got)


# ---------------------------------------------------------------------------
# K4: bias + ReLU + BatchNorm (tpuseg_torch/csrc/batchnorm.cu)
# ---------------------------------------------------------------------------

def _k4_case(shape, dtype, seed, dev, bias, strided):
    """x and g as the model hands them: rows of channels, g optionally a
    concat's channel slice (rows of stride 2C), and the per-channel vectors."""
    rng = np.random.default_rng(seed)
    n, c, h, w = shape

    def rows(wide):
        t = torch.from_numpy(rng.normal(0.3, 1.0, (n, 2 * c if wide else c, h, w))
                             .astype(np.float32)).to(dev, dtype)
        t = t.contiguous(memory_format=torch.channels_last)
        return t[:, c:] if wide else t

    x, g = rows(False), rows(strided)
    b = torch.from_numpy(rng.normal(0, 0.5, c).astype(np.float32)).to(dev) if bias else None
    vec = {k: torch.from_numpy(rng.uniform(lo, hi, c).astype(np.float32)).to(dev)
           for k, lo, hi in (("mean", -0.5, 0.5), ("rstd", 0.5, 2.0), ("mul", -2.0, 2.0),
                             ("beta", -0.5, 0.5), ("k1", -0.3, 0.3), ("k2", -0.3, 0.3))}
    return x, g, b, vec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu, bias", [(True, True), (False, False)])
@pytest.mark.parametrize("shape, strided", [
    ((3, 2, 5, 7), False), ((3, 2, 5, 7), True), ((2, 64, 9, 11), False),
    ((2, 64, 9, 11), True), ((1, 1024, 3, 5), False), ((2, 24, 4, 4), True),
    ((1, 3, 7, 7), False), ((2, 200, 3, 3), False), ((3, 1, 5, 7), False),
    ((1, 4, 9, 9), False), ((2, 2, 33, 35), False)])
def test_batchnorm_kernels_match_plain(cuda, shape, strided, relu, bias, dtype):
    """(b) and (d) bit-equal to their plain versions given the same vectors,
    (a) and (c) within the bound of their summation, which planted faults
    fail (``chip_smoke.k4_sum_check``), and (a)'s count row n; odd M (105, 81 and 2310 rows), C 1, 2 (the
    head) and 4 (the packed narrow path where the rows divide 16 bytes,
    its last load masked; one element a thread where g is a channel
    slice), 3, 24 (not a multiple of 8: bf16's narrow path), 64, 200 (4
    channel tiles, the last partial), 1024; g a channel slice or not."""
    x, g, b, v = _k4_case(shape, dtype, sum(shape) + strided, cuda, bias, strided)
    before = dict(k4.LAUNCHES)
    stats = k4.batch_stats(x, b, relu)
    y, vec = k4.bn_apply_train(x, b, relu, stats, v["mul"], v["beta"], 1e-3)  # gamma: v's mul
    sums = k4.backward_reduce(x, b, relu, g, v["mean"], v["rstd"])
    dx = k4.backward_apply(x, b, relu, g, v["mean"], v["rstd"], v["mul"], v["k1"], v["k2"])
    torch.cuda.synchronize()
    assert all(k4.LAUNCHES[k] == before[k] + 1 for k in before)
    assert torch.equal(y, k4._apply_plain(x, b, relu, vec[0], vec[3], v["beta"]))
    assert torch.equal(dx, k4._backward_apply_plain(x, b, relu, g, v["mean"], v["rstd"],
                                                    v["mul"], v["k1"], v["k2"]))
    assert k4.row_stride(y) == k4.row_stride(dx) == shape[1]
    a = k4.activation(x, b, relu).float().permute(1, 0, 2, 3).reshape(shape[1], -1)
    assert stats.shape == (3, shape[1])
    assert (stats[2] == shape[0] * shape[2] * shape[3]).all()
    ad = a.double()
    smoke.k4_sum_check("stats", stats[:2], None, [lambda: ad, lambda: ad * ad],
                       k4.reduce_plan(x, k4.row_stride(x)))
    gf = g.float().permute(1, 0, 2, 3).reshape(shape[1], -1).double()
    ah = ((a - v["mean"][:, None]) * v["rstd"][:, None]).double()
    terms = [gf, gf * ah]
    if bias:
        m = (a > 0) if relu else torch.ones_like(a, dtype=torch.bool)
        terms += [torch.where(m, gf, 0.0), m.double(), torch.where(m, ah, 0.0)]
    assert sums.shape == (len(terms), shape[1])
    smoke.k4_sum_check("backward reduce", sums, None, [lambda t=t: t for t in terms],
                       k4.reduce_plan(x, k4.row_stride(x), g, k4.row_stride(g), len(terms)))


def _ulps(a, b) -> int:
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [False, True], ids=["no_group", "group"])
@pytest.mark.parametrize("c", [2, 3, 16, 64, 1024])
def test_batchnorm_train_vectors_match_finalize(cuda, c, group, dtype):
    """(b) in train mode derives in the kernel what ``finalize`` gives on
    the same sums (with a group: sums and n as an all-reduce over two
    ranks with the same batch leaves them, doubled): mean, variance and
    mask bit-equal, rstd and mul within 2 ulps (rsqrtf's bound; counted,
    equal where the kernel's rsqrtf is what torch.rsqrt runs), y bit-equal
    to (b) on the kernel's own vectors, the running statistics bit-equal
    to the two-line update; (d) in train mode bit-equal to (d) and the
    bias gradient to the eager formula, k1 and k2 taken eagerly from the
    same totals; eval-mode (b) against its plain version. A constant
    channel's variance clips or comes out near 0."""
    shape = (2, c, 9, 11)
    x, g, b, _ = _k4_case(shape, dtype, c + 7 * group, cuda, True, False)
    x[:, 0] = 0.5
    rng = np.random.default_rng(c)
    gamma, beta, rm0 = (torch.from_numpy(rng.normal(m, 0.3, c).astype(np.float32)).to(cuda)
                        for m in (1.0, 0.0, 0.0))
    rv0 = torch.from_numpy(rng.uniform(0.5, 2, c).astype(np.float32)).to(cuda)
    stats = k4.batch_stats(x, b, True)
    if group:
        stats = stats * 2
    rm, rv = rm0.clone(), rv0.clone()
    y, vec = k4.bn_apply_train(x, b, True, stats, gamma, beta, 1e-3, rm, rv, 0.99)
    mean, var, unclipped, rstd, mul = k4.finalize(stats, 1e-3, gamma)
    assert torch.equal(vec[0], mean) and torch.equal(vec[1], var)
    # the constant channel's fast variance: 0, clipped, or rounding's few ulps of a^2
    assert torch.equal(vec[4] != 0, unclipped) and vec[1][0] <= 1e-5
    assert _ulps(vec[2], rstd) <= 2 and _ulps(vec[3], mul) <= 2
    assert torch.equal(y, k4._apply_plain(x, b, True, vec[0], vec[3], beta))
    assert torch.equal(rm, 0.99 * rm0 + (1 - 0.99) * vec[0])
    assert torch.equal(rv, 0.99 * rv0 + (1 - 0.99) * vec[1])
    sums = k4.backward_reduce(x, b, True, g, vec[0], vec[2])
    totals = (2 * sums[:2]).contiguous() if group else sums
    dx, dbias = k4.backward_apply_train(x, b, True, g, stats, vec, sums, totals)
    k1 = totals[0] / stats[2]
    k2 = torch.where(vec[4] != 0, totals[1] / stats[2], 0.0)
    assert torch.equal(dx, k4._backward_apply_plain(x, b, True, g, vec[0], vec[2], vec[3], k1,
                                                    k2))
    assert torch.equal(dbias, vec[3] * ((sums[2] - k1 * sums[3]) - k2 * sums[4]))
    ye = k4.bn_apply_eval(x, b, True, rm0, rv0, gamma, beta, 1e-3)
    want = k4._apply_eval_plain(x, b, True, rm0, rv0, gamma, beta, 1e-3)
    if _ulps(vec[2], rstd) == 0:
        assert torch.equal(ye, want)
    else:
        assert (ye.float() - want.float()).abs().max() <= 2 ** -6 * want.float().abs().max()


@pytest.mark.cuda
def test_train_conv_bn_on_card_issues_only_k4(cuda):
    """A train-mode conv_bn without a group, forward and backward, on the
    card: K4's four launches and, by a dispatch mode, no other op than
    allocations and views. A first step runs unrecorded: it makes the
    reductions' counters, zeroed once a stream, whichever test runs first."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    x, g, b, _ = _k4_case((2, 16, 8, 8), torch.bfloat16, 3, cuda, True, False)
    x, b = x.requires_grad_(), b.requires_grad_()
    norm = torch.nn.BatchNorm2d(16, eps=1e-3).to(cuda).train()
    k4.conv_bn(x, b, True, norm, 0.99).backward(g)
    for t in (x, b, norm.weight, norm.bias):
        t.grad = None
    k4.reset_counts()
    with Record():
        k4.conv_bn(x, b, True, norm, 0.99).backward(g)
    torch.cuda.synchronize()
    assert set(ops) <= {"empty", "empty_like", "empty_strided", "select", "slice", "alias",
                        "view", "as_strided", "detach"}, sorted(set(ops))
    assert k4.LAUNCHES == {"stats": 1, "apply": 1, "backward_reduce": 1, "backward_apply": 1}
    assert x.grad is not None and b.grad is not None and norm.weight.grad is not None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("where", sorted(smoke.K4_SHAPES))
def test_batchnorm_at_the_train_path_shapes(cuda, where, dtype):
    smoke.k4_check(where, *smoke.k4_inputs(smoke.K4_SHAPES[where], dtype, 0, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_batchnorm_reductions_are_deterministic(cuda, dtype):
    """Per-block partials and an ordered last-block sum: the same bits every
    launch (the counters are left at zero), at enc1's width."""
    x, g, b, v = _k4_case((4, 64, 64, 64), dtype, 3, cuda, True, False)
    first = [k4.batch_stats(x, b, True), k4.backward_reduce(x, b, True, g, v["mean"], v["rstd"])]
    for _ in range(3):
        assert torch.equal(k4.batch_stats(x, b, True), first[0])
        assert torch.equal(k4.backward_reduce(x, b, True, g, v["mean"], v["rstd"]), first[1])


@pytest.mark.cuda
def test_batchnorm_kernels_refuse_what_they_do_not_take(cuda):
    x, g, b, v = _k4_case((2, 8, 4, 4), torch.float32, 1, cuda, True, False)
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.bn_apply_eval(x.contiguous(), b, True, v["mean"], v["rstd"], v["mul"], v["beta"],
                         1e-3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.batch_stats(x.half(), b, True)
    with pytest.raises(ValueError, match="float32"):
        k4.bn_apply_eval(x, b, True, v["mean"].double(), v["rstd"], v["mul"], v["beta"], 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("train", [True, False])
def test_conv_block_on_card_matches_cpu(cuda, train):
    """The conv block (f32, TF32 off) forward and backward through K4 on the
    card against the same block on the CPU: within 1e-4 of each tensor's
    largest |value| (f32 conv and batch sums in other orders)."""
    from tpuseg_torch.models.unet import ConvBlock

    torch.manual_seed(0)
    cpu = ConvBlock(16, 32).train(train)
    with torch.no_grad():
        cpu.conv.bias.normal_(0, 0.3)
        cpu.bn.weight.uniform_(0.5, 1.5)
    card = ConvBlock(16, 32).to(cuda).train(train)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 20, 24).contiguous(memory_format=torch.channels_last)
    r = torch.randn(2, 32, 20, 24)
    k4.reset_counts()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        outs = []
        for block, dev in ((cpu, "cpu"), (card, cuda)):
            xi = x.to(dev).detach().requires_grad_()
            (block(xi, torch.float32) * r.to(dev)).sum().backward()
            outs.append([xi.grad, block.conv.weight.grad, block.conv.bias.grad,
                         block.bn.weight.grad, block.bn.bias.grad, block.bn.running_var])
    want = {"stats": 1, "apply": 1, "backward_reduce": 1, "backward_apply": 1} if train else \
        {"stats": 0, "apply": 1, "backward_reduce": 1, "backward_apply": 1}
    assert k4.LAUNCHES == want
    for got, ref in zip(outs[1], outs[0]):
        got, ref = got.detach().cpu(), ref.detach()
        assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# K4's store forms: (b) in eval mode into a concat buffer's channel slice,
# and with the 2x2/2 max of y from the same pass (the bf16 walk's skips)

def _bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit patterns, every NaN as one pattern (its payload aside)."""
    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _k4_eval_case(shape, dtype, seed, dev, nan):
    """A conv block's x (with a NaN in a pool window if ``nan``), a deconv
    block's x, and eval BatchNorm's running statistics, gamma and beta."""
    x, up, b, v = _k4_case(shape, dtype, seed, dev, True, False)
    if nan:
        x[0, 0, 0, 1] = float("nan")
        x[-1, -1, -1, -1] = float("nan")
    rng = np.random.default_rng(seed)
    rv = torch.from_numpy(rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)).to(dev)
    return x, up, b, (v["mean"], rv, v["mul"], v["beta"])


@pytest.mark.cuda
@pytest.mark.parametrize("nan", [False, True], ids=["finite", "nan"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (2, 64, 1024, 1024), (2, 128, 512, 512), (2, 256, 256, 256), (2, 512, 128, 128),
    (3, 24, 6, 10), (1, 3, 4, 6), (2, 4, 2, 2), (1, 200, 10, 4)])
def test_batchnorm_store_forms_bit_equal_to_plain(cuda, shape, dtype, nan):
    """The slice and pooled forms of (b) at the enc1b-enc4b and dec-up
    shapes of a batch-2, 1024^2 call and at ragged even shapes (C 24 and 3:
    one element a thread; C 4: the packed path's width, which the forms
    take one element a thread; C 200: a partial channel tile): the concat
    buffer bit-equal to ``torch.cat`` of (b)'s two outputs, nothing written
    outside each slice, the pooled output bit-equal to ``F.max_pool2d`` of
    (b)'s y (channels-last), a NaN in a window included; one "apply" launch
    each, counted in ``FORMS``."""
    import torch.nn.functional as F

    n, c, h, w = shape
    x, up, b, stats = _k4_eval_case(shape, dtype, sum(shape), cuda, nan)
    y_old = k4.bn_apply_eval(x, b, True, *stats, 1e-3)
    up_old = k4.bn_apply_eval(up, None, False, *stats, 1e-3)
    want_cat, want_pool = torch.cat([y_old, up_old], 1), F.max_pool2d(y_old, 2)
    buf = torch.full((n, 2 * c, h, w), 7.0, dtype=dtype, device=cuda).contiguous(
        memory_format=torch.channels_last)
    k4.reset_counts()
    y, pooled = k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=buf[:, :c], pool=True)
    assert torch.equal(_bits(buf[:, c:]), _bits(torch.full_like(up_old, 7.0)))
    got_up = k4.bn_apply_eval(up, None, False, *stats, 1e-3, out=buf[:, c:])
    torch.cuda.synchronize()
    assert y.data_ptr() == buf.data_ptr() and got_up.data_ptr() == buf[:, c:].data_ptr()
    assert k4.LAUNCHES["apply"] == 2 and k4.FORMS == {"slice": 2, "pool": 1}
    assert torch.equal(_bits(buf), _bits(want_cat))
    assert pooled.shape == (n, c, h // 2, w // 2) and k4.row_stride(pooled) == c
    assert torch.equal(_bits(pooled), _bits(want_pool))
    assert bool(torch.isnan(pooled).any()) == nan
    # the pooled form alone, into a fresh y
    y2, pooled2 = k4.bn_apply_eval(x, b, True, *stats, 1e-3, pool=True)
    assert torch.equal(_bits(y2), _bits(y_old)) and torch.equal(_bits(pooled2), _bits(want_pool))


@pytest.mark.cuda
def test_batchnorm_eval_forms_at_the_serving_shape(cuda):
    smoke.k4_forms_check(*smoke.k4_form_inputs(0, cuda))


@pytest.mark.cuda
def test_batchnorm_store_forms_refused(cuda):
    x, _, b, stats = _k4_eval_case((2, 8, 6, 10), torch.bfloat16, 1, cuda, False)
    odd = _k4_eval_case((2, 8, 5, 10), torch.bfloat16, 1, cuda, False)[0]
    with pytest.raises(ValueError, match="even H and W"):
        k4.bn_apply_eval(odd, b, True, *stats, 1e-3, pool=True)
    buf = torch.empty((2, 16, 6, 10), dtype=torch.bfloat16, device=cuda)  # NCHW
    with pytest.raises(ValueError, match="not rows of channels"):
        k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=buf[:, :8])
    wide = buf.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="does not match"):
        k4.bn_apply_eval(x, b, True, *stats, 1e-3, out=wide[:, :4])


def _eval_unet(base, dtype, seed, dev):
    from tpuseg_torch.models.unet import UNet, init_unet

    g = torch.Generator().manual_seed(seed)
    model = init_unet(UNet(2, 1, base, dtype=dtype), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.bias.normal_(0, 0.3, generator=g)
    return model.to(dev).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unet_eval_forms_on_card_bit_equal(cuda, dtype):
    """The eval walk on the card: under ``inference_mode`` (the store forms:
    8 slices, 4 pooled, no concat or pool) and with grad enabled (the
    concat and pool), 23 applies each, the same logits bit for bit."""
    model = _eval_unet(16, dtype, 0, cuda)
    x = torch.randn(2, 256, 320, 1, device=cuda)
    k4.reset_counts()
    with torch.inference_mode():
        forms = model(x)
    assert k4.FORMS == {"slice": 8, "pool": 4} and k4.LAUNCHES["apply"] == 23
    k4.reset_counts()
    plain = model(x)
    assert k4.FORMS == {"slice": 0, "pool": 0} and k4.LAUNCHES["apply"] == 23
    assert torch.equal(_bits(forms), _bits(plain.detach()))


@pytest.mark.cuda
def test_tiled_none_forms_masks_equal_grad_path(cuda):
    """``inference_tiled`` on ``none`` (bf16): the masks through the store
    forms equal, on every pixel, those of a predict function that runs the
    model with grad enabled (today's concat and pool); 8 slices and 4 pools
    a predict call."""
    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer.tiled import inference_tiled, make_predict_fn

    model = _eval_unet(16, torch.bfloat16, 1, cuda)
    img = np.random.default_rng(2).normal(2000, 300, (1100, 1500)).clip(0, 65535)
    img = img.astype(np.uint16)
    stats = zscore_stats(img)

    def grad_predict(batch):
        with torch.enable_grad():
            return torch.argmax(model(batch), dim=-1).to(torch.int32)

    k4.reset_counts()
    got = inference_tiled(img, make_predict_fn(model), 512, 96, 8, 2, stats, cuda)
    calls = k4.LAUNCHES["apply"] // 23
    assert calls >= 2 and k4.FORMS == {"slice": 8 * calls, "pool": 4 * calls}
    k4.reset_counts()
    want = inference_tiled(img, grad_predict, 512, 96, 8, 2, stats, cuda)
    assert k4.FORMS == {"slice": 0, "pool": 0} and k4.LAUNCHES["apply"] == 23 * calls
    assert got.shape == want.shape == img.shape
    assert (got == want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["none", "int8_blocked"])
def test_tiled_pipeline_at_the_cells_geometry(cuda, mode):
    """The serving cells' pass (4096^2 uint16, tile 1024, radius 96, calls
    of 8) through the copy pipeline, with the cells' U-Net (its head
    shaped so that both classes take many pixels): masks equal on every
    pixel to the whole-image stitch with the same predict function, twice
    in a row; 2 of the 4 calls queued before the last band's wait, 3 of
    the 4 download bands before the last call; in the device trace the
    upload below row 1760 and the download above row 3328 crossed, for
    most of their time, while the card worked on the calls."""
    from tpuseg_torch.data.preprocess import zscore_stats
    from tpuseg_torch.infer import quant
    from tpuseg_torch.infer.tiled import make_predict_fn
    from tpuseg_torch.models.unet import UNet

    img = np.random.default_rng(7).normal(2000, 300, (4096, 4096)).clip(0, 65535)
    img = img.astype(np.uint16)
    stats = zscore_stats(img)
    model, _ = smoke.serving_unet(3, img, cuda)
    if mode == "none":
        bf16 = UNet(2, 1, 64, dtype=torch.bfloat16)
        bf16.load_state_dict(model.state_dict())
        fn = make_predict_fn(bf16.to(cuda).eval())
    else:
        folded = quant.fold_variables(model.to(cuda))
        crop = (img[1536:2560, 1536:2560, None].astype(np.float32) - stats[0]) / stats[1]
        fn = quant.make_quantized_predict_fn(
            folded, quant.calibrate(folded, [crop], device=cuda), blocked_edges=True)
    res = smoke.tiled_pipeline_check(img, fn, 96, stats, cuda)
    assert res["pipeline"] == {"upload_bands": 3, "early_calls": 2, "download_bands": 4,
                               "early_downloads": 3}
    assert res["overlapped_bytes"] == {"HtoD": (4096 - 1760) * 4096 * 2, "DtoH": 3328 * 4096}
    assert 0.01 < res["class1_share"] < 0.99


# K4's train forms: (b)'s store forms in train mode, and the pooled (c) and
# (d), which take the pool's gradient at each window's argmax

def _k4_train_case(shape, dtype, seed, dev):
    """A conv block's x, its bias, gamma and beta, a deconv block's x, the
    concat buffer's gradient (rows of stride 2C) and the pooled output's."""
    x, up, b, v = _k4_case(shape, dtype, seed, dev, True, False)
    n, c, h, w = shape
    gcat = _k4_case((n, 2 * c, h, w), dtype, seed + 1, dev, False, False)[0]
    gp = _k4_case((n, c, h // 2, w // 2), dtype, seed + 2, dev, False, False)[0]
    gamma = v["rstd"] * torch.sign(v["mul"])  # a sign flip: maxima from both tails
    return x, up, b, gamma, v["beta"], gcat, gp


TRAIN_FORM_SHAPES = [(16, 64, 512, 512), (16, 128, 256, 256), (16, 256, 128, 128),
                     (3, 24, 6, 10), (1, 3, 4, 6), (2, 4, 2, 2), (1, 200, 10, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", TRAIN_FORM_SHAPES)
def test_batchnorm_train_forms_bit_equal_to_plain(cuda, shape, dtype):
    """At enc1b-enc3b's and dec1up-dec3up's shapes of a batch-16, 512^2
    train step and at ragged even shapes (C 24 and 3: one element a thread;
    C 4: the packed width, which the forms take one element a thread; C
    200: a partial channel tile): ``chip_smoke.k4_train_forms_check``."""
    x, up, b, gamma, beta, gcat, gp = _k4_train_case(shape, dtype, sum(shape), cuda)
    smoke.k4_train_forms_check(x, b, gamma, beta, up, gcat, gp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unet_train_forms_on_card(cuda, dtype, monkeypatch):
    """A train step with dropout on through the train forms (6 slices, 3
    pools, 3 pooled backwards; 23 launches of each kernel) against the same
    step with the pool swapped for a wrapper of ``F.max_pool2d`` (the
    concat, the pool and autograd's add): logits and running statistics bit
    for bit; each parameter's gradient within 1e-3 (f32) or 1e-2 (bf16) of
    its norm, the pooled (c) summing in another order than the plain (c).
    Measured on an H100: at most 1.3e-4 (f32, enc1a's BN bias: its (c)'s
    per-channel offsets add up coherently downstream) and 4.6e-4 (bf16); on
    the CPU a pool gradient dropped or sent to one fixed tap reads 1.1-1.9
    (a tie broken the other way, 7e-7 in f32, is the bit-equal tests')."""
    import copy

    import torch.nn.functional as F

    from tpuseg_torch.models import unet
    from tpuseg_torch.ops.losses import cce_from_logits, reference_scalar_loss

    forms = _eval_unet(16, dtype, 3, cuda).train()
    swapped = copy.deepcopy(forms)
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(4, 256, 320, 1, device=cuda, generator=g)
    labels = F.one_hot((torch.rand(4, 256, 320, device=cuda, generator=g) > 0.5).long(),
                       2).float()

    def step(model):
        k4.reset_counts()
        logits = model(x, generator=torch.Generator(device=cuda).manual_seed(5))
        reference_scalar_loss(cce_from_logits(logits, labels), x.shape[0]).backward()
        torch.cuda.synchronize()
        return logits.detach()

    got = step(forms)
    assert k4.TRAIN_FORMS == {"slice": 6, "pool": 3, "pooled_backward": 3}
    assert k4.LAUNCHES == {k: 23 for k in k4.LAUNCHES}
    monkeypatch.setattr(unet, "_pool", lambda t: F.max_pool2d(t, 2))
    want = step(swapped)
    assert all(v == 0 for v in k4.TRAIN_FORMS.values())
    assert torch.equal(_bits(got), _bits(want))
    for (name, b), c in zip(forms.named_buffers(), swapped.buffers()):
        assert torch.equal(b, c), name
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-3
    gaps = {name: float((p.grad - q.grad).norm() / q.grad.norm())
            for (name, p), q in zip(forms.named_parameters(), swapped.parameters())}
    print("largest gradient gaps:", sorted(gaps.items(), key=lambda kv: -kv[1])[:4])
    assert max(gaps.values()) <= tol


@pytest.mark.cuda
def test_unet_train_steps_through_k4_and_its_plain_versions(cuda):
    from tpuseg_torch.aug.device import DeviceAugmentParams

    spec = {"pool": smoke.TRAIN_BATCH, "size": smoke.TRAIN_SIZE}
    raw_img, raw_msk = smoke.bench("traffic.blobs").make_pool(spec, 3, cuda)
    smoke.k4_parity(0, cuda, raw_img, raw_msk, DeviceAugmentParams())
