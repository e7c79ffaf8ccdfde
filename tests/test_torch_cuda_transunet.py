"""TransUNet's parts that need the card: K4's order after (BatchNorm, then
ReLU) against its plain versions, bit for bit, and the model's train and
test steps through the flash attention backend and those kernels. They
skip without an NVIDIA card (a CUDA kernel has no CPU mode).

This file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_transunet.py
"""

import os
import sys

import pytest
import torch

from tpuseg_torch.models import transunet as tu
from tpuseg_torch.ops import batchnorm as k4

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402

TINY = dict(width=32, block_units=(1, 1, 1), hidden=64, num_layers=2, num_heads=4, mlp_dim=128,
            img_size=64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(shape, dtype, seed, dev, grad_rows=None):
    """x (channels-last), gamma, beta and a gradient; ``grad_rows`` C' > C
    hands the gradient as a channel slice of rows of C' (a concat's)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n, c, h, w = shape
    x = (torch.randn((n, h, w, c), generator=g, device=dev) * 0.8 + 0.1).to(dtype)
    gamma = torch.rand(c, generator=g, device=dev) + 0.5
    beta = torch.randn(c, generator=g, device=dev) * 0.3
    gw = grad_rows or c
    gy = (torch.randn((n, h, w, gw), generator=g, device=dev) * 1e-3).to(dtype)[..., :c]
    return x.permute(0, 3, 1, 2), gamma, beta, gy.permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, grad_rows", [((4, 16, 32, 24), None), ((2, 64, 16, 16), 96),
                                              ((4, 2, 20, 12), None), ((4, 3, 20, 12), None),
                                              ((2, 520, 8, 8), None)])
def test_k4_after_matches_plain(cuda, shape, grad_rows, dtype):
    """(b) and (d), train and eval, bit-equal to the plain versions given the
    same vectors; (a) and (c) within f32 round-off of them (another
    summation order: 1e-5 of the sum of magnitudes, far above the
    recursive-summation bound of a few hundred terms a lane)."""
    after = k4.RELU_AFTER
    x, gamma, beta, gy = _inputs(shape, dtype, sum(shape), cuda, grad_rows)
    stats = k4.batch_stats(x, None, after)
    plain_stats = k4._stats_count_plain(x, None, after)
    mag = k4._stats_count_plain(x.abs(), None, after)
    assert torch.equal(stats[2], plain_stats[2])
    assert bool(((stats[:2] - plain_stats[:2]).abs() <= 1e-5 * mag[:2] + 1e-30).all())
    run = (torch.zeros(shape[1], device=cuda), torch.ones(shape[1], device=cuda))
    y, vec = k4.bn_apply_train(x, None, after, stats, gamma, beta, 1e-5, *run, 0.9)
    mean, rstd, mul = vec[0], vec[2], vec[3]
    assert torch.equal(y, k4._apply_plain(x, None, after, mean, mul, beta))
    assert k4.row_stride(y) == shape[1] and bool((y >= 0).all())
    sums = k4.backward_reduce(x, None, after, gy, mean, rstd, mul, beta)
    plain = k4._backward_reduce_plain(x, None, after, gy, mean, rstd, mul, beta)
    gp = k4._after_gradient(x, gy, mean, mul, beta).float()
    ahat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
    mag = torch.stack([gp.abs().sum((0, 2, 3)), (gp * ahat).abs().sum((0, 2, 3))])
    assert bool(((sums - plain).abs() <= 1e-5 * mag + 1e-30).all())
    dx, dbias = k4.backward_apply_train(x, None, after, gy, stats, vec, sums, sums, beta)
    k1 = sums[0] / stats[2]
    k2 = torch.where(vec[4] != 0, sums[1] / stats[2], 0.0)
    assert dbias is None
    assert torch.equal(dx, k4._backward_apply_plain(x, None, after, gy, mean, rstd, mul, k1, k2,
                                                    beta))
    rm, rv = torch.randn(shape[1], device=cuda) * 0.3, torch.rand(shape[1], device=cuda) + 0.5
    ye = k4.bn_apply_eval(x, None, after, rm, rv, gamma, beta, 1e-5)
    assert torch.equal(ye, k4._apply_eval_plain(x, None, after, rm, rv, gamma, beta, 1e-5))
    rs = torch.rsqrt(rv + 1e-5)
    zero = torch.zeros_like(rm)
    dxe = k4.backward_apply(x, None, after, gy, rm, rs, rs * gamma, zero, zero, beta)
    assert torch.equal(dxe, k4._backward_apply_plain(x, None, after, gy, rm, rs, rs * gamma,
                                                     zero, zero, beta))


@pytest.mark.cuda
@pytest.mark.parametrize("where, dtype", smoke.K4_AFTER_CASES,
                         ids=[f"{k}-{d}" for k, d in smoke.K4_AFTER_CASES])
def test_k4_after_at_the_decoder_shapes(cuda, where, dtype):
    """The decoder's batch-16, 512^2 shapes, then the packed narrow path
    and the element path: ``chip_smoke.k4_after_check``."""
    shape = smoke.K4_AFTER_SHAPES[where]
    x, _, gamma, beta, gy = smoke.k4_inputs(shape, getattr(torch, dtype), 100, cuda)
    smoke.k4_after_check(f"{where}_{dtype}", x, gamma, beta, gy)


@pytest.mark.cuda
def test_k4_after_refuses_a_bias_and_the_store_forms(cuda):
    x, gamma, beta, _ = _inputs((2, 16, 8, 8), torch.bfloat16, 1, cuda)
    bias = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="no bias"):
        k4.batch_stats(x, bias, k4.RELU_AFTER)
    with pytest.raises(ValueError, match="store forms"):
        k4.bn_apply_eval(x, None, k4.RELU_AFTER, gamma * 0, gamma, gamma, beta, 1e-5, pool=True)


@pytest.mark.cuda
def test_transunet_steps_on_the_card(cuda):
    """A bf16 train step of the tiny model through the flash backend and
    K4's order after (36 launches: nine layers, four kernels), then a test
    forward (nine eval applies); the loss is finite and the f32 model on
    the card agrees with its CPU run within f32 round-off of cuDNN's and
    the CPU's conv and GEMM orders (1e-4 of the logits' scale)."""
    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.train.steps import create_train_state, make_raw_steps

    model = tu.TransUNet(dtype="bfloat16", **TINY)
    state = create_train_state(model, 3, 3e-4, cuda)
    step, estep = make_raw_steps(2, DeviceAugmentParams())
    g = torch.Generator(device=cuda).manual_seed(0)
    img = (torch.rand((4, 64, 64, 1), generator=g, device=cuda) * 4000).to(torch.int32)
    msk = (torch.rand((4, 64, 64), generator=g, device=cuda) > 0.5).to(torch.uint8)
    k4.reset_counts()
    tu.reset_counts()
    loss = step(state, img, msk)["loss"]
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert k4.AFTER == {"launches": 36, "applies": 9}
    assert tu.COUNTS == {"attention": 2, "group_norm": 13}
    assert torch.isfinite(estep(state, img, msk)["loss"])
    assert k4.AFTER["applies"] == 18

    f32 = tu.TransUNet(dtype="float32", **TINY)
    tu.init_transunet(f32, torch.Generator().manual_seed(5))
    f32.eval()
    x = torch.randn(2, 64, 64, 1)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = f32(x)
            got = f32.to(cuda)(x.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
