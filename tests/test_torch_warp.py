"""The port's warp (tpuseg_torch/ops/warp.py) against tpuseg.ops.warp on
the CPU, where the port's shear (K1) runs its plain version.

- _shear_rows_plain against all three JAX forms of the shear: the XLA
  barrel shifter (default) and the two Pallas kernels (roll, dma) in
  interpret mode, selected as tests/test_shear_impls.py selects them;
  atol 1e-7, as that file pins the JAX forms to each other.
- rotate and warp_affine_batch against JAX at angles covering every
  quarter-turn and +-45 degrees, square and non-square-padded inputs;
  atol 1e-5 (tan/sin and the matmul sums may round differently).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops import warp as jw
from tpuseg_torch.ops import warp as tw


def _shear_case(seed, n=2, h=32, w=64):
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w)).astype(np.float32)
    off = rng.uniform(-8, 8, (n, h)).astype(np.float32)
    return img, off


@pytest.mark.parametrize("mode", ["barrel", "roll", "dma"])
def test_shear_plain_matches_every_jax_form(monkeypatch, mode):
    monkeypatch.setattr(jw, "_SHEAR_MODE", mode)
    img, off = _shear_case(0)
    want = np.asarray(jw._apply_shear_x(jnp.asarray(img), jnp.asarray(off)))
    got = tw._apply_shear_x(torch.from_numpy(img), torch.from_numpy(off)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


@pytest.mark.parametrize("mode", ["barrel", "roll", "dma"])
def test_shear_rows_contract(monkeypatch, mode):
    """The row-shear function itself, on padded rows and in-range shifts
    from 0 to Wp-W-1 (both clip ends)."""
    monkeypatch.setattr(jw, "_SHEAR_MODE", mode)
    rng = np.random.default_rng(1)
    n, h, wp, w = 2, 16, 64 + 2 * 8, 64
    img = rng.random((n, h, wp)).astype(np.float32)
    shift = rng.integers(0, wp - w, (n, h)).astype(np.int32)
    shift[0, 0], shift[0, 1] = 0, wp - w - 1
    frac = rng.random((n, h)).astype(np.float32)
    want = np.asarray(jw._shear_rows(jnp.asarray(img), jnp.asarray(shift),
                                     jnp.asarray(frac), w))
    got = tw._shear_rows(torch.from_numpy(img), torch.from_numpy(shift),
                         torch.from_numpy(frac), w).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_shear_y_matches():
    img, off = _shear_case(2, h=48, w=48)
    want = np.asarray(jw._apply_shear_y(jnp.asarray(img), jnp.asarray(off[:, :48])))
    got = tw._apply_shear_y(torch.from_numpy(img), torch.from_numpy(off[:, :48])).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_shear_wrapper_checks_inputs():
    img = torch.zeros(2, 4, 20)
    shift = torch.zeros(2, 4, dtype=torch.int32)
    frac = torch.zeros(2, 4)
    with pytest.raises(TypeError):
        tw._shear_rows(img.double(), shift, frac, 10)
    with pytest.raises(TypeError):
        tw._shear_rows(img, shift.long(), frac, 10)
    with pytest.raises(ValueError):
        tw._shear_rows(img, shift, frac, 20)
    before = tw.LAUNCHES
    tw._shear_rows(img, shift, frac, 10)
    assert tw.LAUNCHES == before  # the CPU path launches nothing


# every quarter-turn, +-45 degrees around them, and in between
THETAS = [0.0, math.pi / 4, -math.pi / 4, math.pi / 2, 3 * math.pi / 4, math.pi,
          5 * math.pi / 4, 3 * math.pi / 2, 7 * math.pi / 4, 0.3, 2.0, 5.9]


@pytest.mark.parametrize("size, c", [(32, 1), (48, 2)])
def test_rotate_matches(size, c):
    rng = np.random.default_rng(size)
    x = rng.normal(0, 1, (len(THETAS), size, size, c)).astype(np.float32)
    theta = np.asarray(THETAS, np.float32)
    want = np.asarray(jw.rotate(jnp.asarray(x), jnp.asarray(theta)))
    got = tw.rotate(torch.from_numpy(x), torch.from_numpy(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rot90_exact():
    x = np.arange(2 * 4 * 4 * 1, dtype=np.float32).reshape(2, 4, 4, 1)
    for k in range(4):
        kk = np.full((2,), k, np.int32)
        want = np.asarray(jw._rot90_batch(jnp.asarray(x), jnp.asarray(kk)))
        got = tw._rot90_batch(torch.from_numpy(x), torch.from_numpy(kk)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[0, ..., 0], np.rot90(x[0, ..., 0], k))


@pytest.mark.parametrize("size", [32, 64])
def test_warp_affine_batch_matches(size):
    rng = np.random.default_rng(7)
    b = 6
    x = rng.normal(0, 1, (b, size, size, 2)).astype(np.float32)
    theta = np.asarray([0.0, math.pi / 4, -math.pi / 4, math.pi, 4.0, 1.2], np.float32)
    tx = rng.integers(-3, 4, b).astype(np.float32)
    ty = rng.integers(-3, 4, b).astype(np.float32)
    sx = rng.uniform(0.9, 1.1, b).astype(np.float32)
    sy = rng.uniform(0.9, 1.1, b).astype(np.float32)
    args = (x, theta, tx, ty, sx, sy)
    want = np.asarray(jw.warp_affine_batch(*(jnp.asarray(a) for a in args)))
    got = tw.warp_affine_batch(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_mirror_and_resample_weights():
    src = np.linspace(-40, 80, 97, dtype=np.float32)[None]
    want = np.asarray(jw._resample_weights(jnp.asarray(src), 32))
    got = tw._resample_weights(torch.from_numpy(src), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw._mirror_float(torch.tensor([3.0]), 1).numpy(), [0.0])
