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
    want = head_kernel._blocked_head_argmax_plain(x, sv, wt, epi, ncls, fp)
    assert got.shape == (3, 68, 140) and got.dtype == torch.int32
    if fp:
        assert (got == want).float().mean().item() >= 0.999
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("xdtype", [torch.bfloat16, torch.float32])
def test_head_kernel_fp_edge(cuda, xdtype):
    """An fp edge into the head (bf16/f32 activations, sv None)."""
    x, _, wt, epi = _inputs(2, True, 7, 2, 16, 24, 32, cuda)
    xf = (x.float() * 0.05).to(xdtype)
    got = head_kernel.blocked_head_argmax(xf, None, wt, epi, 2, fp=True)
    ones = torch.ones(32, device=cuda)
    want = head_kernel._blocked_head_argmax_plain(xf, ones, wt, epi, 2, True)
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
