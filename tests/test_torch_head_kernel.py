"""K2, the blocked head + per-phase argmax + depth-to-space.

On the CPU the port's ``blocked_head_argmax`` runs its plain PyTorch
version; it is held against the JAX package's Pallas kernel
(``_head_pallas``, interpret mode on the CPU) and against a numpy
evaluation (tests/test_quant.py's). The CUDA kernel itself is held against
the plain version on the card by tests/test_torch_cuda.py and by
chip_smoke.py.

Tolerances: the int8 head sums int8 x int8 products exactly, so its labels
must be bit-equal. The fp head computes the same f32 products but sums
them in another order than XLA, so a genuine argmax near-tie may flip:
labels must agree on at least 0.999 of pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.infer import head_kernel as jax_head
from tpuseg_torch.infer import head_kernel


def _inputs(ncls, fp, seed, b=2, h=6, w=10, c4=16):
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (b, h, w, c4)).astype(np.int8)
    sv = rng.uniform(0.01, 0.1, (c4,)).astype(np.float32)
    if fp:
        wt = rng.normal(0, 0.3, (4 * ncls, c4)).astype(np.float32)
        epi = rng.normal(0, 1, (4, 4 * ncls)).astype(np.float32)
        epi[3] = 1.0
    else:
        wt = rng.integers(-127, 128, (4 * ncls, c4)).astype(np.int8)
        epi = rng.normal(0, 1, (4, 4 * ncls)).astype(np.float32)
        epi[3] = rng.uniform(1e-4, 1e-3, 4 * ncls)
    return x, sv, wt, epi


def _numpy_head(x, sv, wt, epi, ncls, fp):
    b, h, w, _ = x.shape
    if fp:
        y = (x.astype(np.float32) * sv) @ wt.T.astype(np.float32)
    else:
        y = (x.astype(np.int64) @ wt.T.astype(np.int64)).astype(np.float32) * epi[3]
    y = np.maximum(y + epi[0], 0.0) * epi[1] + epi[2]
    lbl = np.argmax(y.reshape(b, h, w, 4, ncls), axis=-1)  # [b,h,w,4]
    dense = lbl.reshape(b, h, w, 2, 2).transpose(0, 1, 3, 2, 4)
    return dense.reshape(b, 2 * h, 2 * w).astype(np.int32)


def _port(x, sv, wt, epi, ncls, fp):
    return head_kernel.blocked_head_argmax(
        torch.from_numpy(x), sv, torch.from_numpy(wt), epi, ncls, fp=fp).numpy()


@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [2, 3, 5])
def test_plain_matches_pallas_kernel(ncls, fp):
    x, sv, wt, epi = _inputs(ncls, fp, seed=ncls)
    want = np.asarray(jax_head._head_pallas(
        jnp.asarray(x), sv, jnp.asarray(wt), epi, ncls, fp))
    got = _port(x, sv, wt, epi, ncls, fp)
    assert got.shape == want.shape == (2, 12, 20) and got.dtype == np.int32
    if fp:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fp", [True, False])
@pytest.mark.parametrize("ncls", [2, 3, 5])
def test_plain_matches_numpy(ncls, fp):
    x, sv, wt, epi = _inputs(ncls, fp, seed=10 + ncls)
    got = _port(x, sv, wt, epi, ncls, fp)
    want = _numpy_head(x, sv, wt, epi, ncls, fp)
    if fp:
        assert (got == want).mean() >= 0.999
    else:
        np.testing.assert_array_equal(got, want)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor takes the plain version and leaves the launch count."""
    before = head_kernel.LAUNCHES
    x, sv, wt, epi = _inputs(2, True, seed=0)
    _port(x, sv, wt, epi, 2, True)
    assert head_kernel.LAUNCHES == before


def test_sv_none_means_ones():
    """An fp edge into the head (sv=None) dequantizes with unit scales."""
    x, _, wt, epi = _inputs(2, True, seed=4)
    xf = torch.from_numpy(x.astype(np.float32))
    got = head_kernel.blocked_head_argmax(xf, None, torch.from_numpy(wt), epi, 2, fp=True)
    want = _numpy_head(x, np.ones(16, np.float32), wt, epi, 2, True)
    assert (got.numpy() == want).mean() >= 0.999


def test_other_devices_raise():
    x, sv, wt, epi = _inputs(2, True, seed=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        head_kernel.blocked_head_argmax(torch.from_numpy(x).to("meta"), sv,
                                        torch.from_numpy(wt), epi, 2, fp=True)
