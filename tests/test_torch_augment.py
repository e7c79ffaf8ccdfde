"""The port's device augmentation (tpuseg_torch/aug/device.py) against
tpuseg.aug.device on the CPU, fed JAX's own random draws.

The test reproduces the key splits of ``tpuseg.aug.device._augment_batch``
with jax.random (the per-sample ``_sample_affine`` and the batch draws),
hands them as numpy to the port's ``apply_augmentation``, z-scores and
one-hots, and compares with ``augment_and_preprocess_batch`` on the same
key: images to atol 1e-4 after z-score, masks on >= 0.999 of pixels
(``round`` of an interpolated 0.5 can flip with the sum order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.aug import device as jd
from tpuseg_torch.aug import device as td


def _raw(b, h, w, c, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    msk = (np.sin(yy / 5.0 + rng.uniform(0, 6, (b, 1, 1))) * np.cos(xx / 7.0) > 0)
    img = 1000 + 2500 * msk[..., None] + rng.normal(0, 300, (b, h, w, c))
    return img.clip(0, 65535).astype(np.uint16), msk.astype(np.uint8)


def jax_draws(rng, b, h, w, c, p):
    """tpuseg.aug.device._augment_batch's draws, split as it splits them."""
    k_params, k_noise_s, k_noise, k_blur, k_int, k_int_sign = jax.random.split(rng, 6)
    theta, rx, ry, tx, ty, sx, sy = jax.vmap(
        lambda k: jd._sample_affine(k, h, w, p))(jax.random.split(k_params, b))
    u = jax.random.uniform(k_noise_s, (b,), minval=-1.0, maxval=1.0)
    noise = jax.random.normal(k_noise, (b, h, w, c))
    sigma = jax.random.uniform(k_blur, (b,), minval=-p.blur_max_sigma, maxval=p.blur_max_sigma)
    value_u = jax.random.uniform(k_int, (b,))
    sign = jnp.where(jax.random.bernoulli(k_int_sign, shape=(b,)), 1.0, -1.0)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.array(a)).to(dt)
    return td.AugmentDraws(t(theta), t(rx, torch.bool), t(ry, torch.bool), t(tx), t(ty),
                           t(sx), t(sy), t(u), t(noise), t(sigma), t(value_u), t(sign))


@pytest.mark.parametrize("h, w, c, intensity", [
    (32, 32, 1, 0.0),   # square: the shear warp directly
    (32, 32, 2, 0.3),   # two channels, intensity shift on
    (32, 48, 1, 0.0),   # non-square: reflect-pad to square, warp, crop
])
def test_augment_matches_jax_on_jax_draws(h, w, c, intensity):
    b = 4
    imgs, msks = _raw(b, h, w, c, h + w + c)
    jp = jd.DeviceAugmentParams(intensity_severity=intensity)
    tp = td.DeviceAugmentParams(intensity_severity=intensity)
    rng = jax.random.PRNGKey(h * 7 + c)
    want_img, want_lbl = jd.augment_and_preprocess_batch(
        rng, jnp.asarray(imgs), jnp.asarray(msks), jp, 2, True)
    draws = jax_draws(rng, b, h, w, c, jp)
    img, mask_f = td.apply_augmentation(torch.from_numpy(imgs.astype(np.float32)),
                                        torch.from_numpy(msks), draws, tp)
    got_img, got_lbl = td.preprocess(img, mask_f.to(torch.int32), 2)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-4)
    agree = (got_lbl.numpy() == np.asarray(want_lbl)).all(-1).mean()
    assert agree >= 0.999, agree


def test_no_augment_is_zscore_and_one_hot():
    imgs, msks = _raw(2, 32, 32, 1, 0)
    want_img, want_lbl = jd.augment_and_preprocess_batch(
        jax.random.PRNGKey(0), jnp.asarray(imgs), jnp.asarray(msks), augment=False)
    got_img, got_lbl = td.augment_and_preprocess_batch(
        None, torch.from_numpy(imgs.astype(np.int32)), torch.from_numpy(msks), augment=False)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))


def test_separable_blur_symmetric_border():
    """numpy-'symmetric' padding built by hand (F.pad has no such mode):
    agrees with JAX at the border to atol 1e-5, and is not 'reflect'."""
    rng = np.random.default_rng(3)
    img = rng.normal(0, 1, (24, 20, 1)).astype(np.float32)
    img[:, 0] += 5.0  # a bright edge column makes the pad mode visible
    sigma = np.float32(1.5)
    kern = np.asarray(jd._gaussian_kernel(jnp.asarray(sigma), 17))
    want = np.asarray(jd._separable_blur(jnp.asarray(img), jnp.asarray(kern)))
    tk = td._gaussian_kernel(torch.tensor([sigma]), 17)
    np.testing.assert_allclose(tk.numpy()[0], kern, rtol=1e-6, atol=1e-7)
    got = td._separable_blur(torch.from_numpy(img)[None], tk)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    x = torch.arange(5.0)
    assert td._pad_symmetric(x, 2, 0).tolist() == [1, 0, 0, 1, 2, 3, 4, 4, 3]


def test_port_draws_have_the_jax_distributions():
    """The port's own generator: the same supports and flags as
    _sample_affine (other numbers than jax.random, by design)."""
    p = td.DeviceAugmentParams()
    d = td.draw_augmentation(torch.Generator().manual_seed(0), 4096, 32, 48, 1, p)
    th = d.theta.numpy()
    assert th.min() >= 0 and th.max() < 2 * np.pi
    assert 0.45 < d.refl_x.float().mean().item() < 0.55
    assert np.all(np.abs(d.tx.numpy()) <= np.floor(0.1 * 48))
    assert np.all(d.tx.numpy() == np.round(d.tx.numpy()))
    assert d.sx.min() >= 0.9 and d.sx.max() <= 1.1
    assert d.noise.shape == (4096, 32, 48, 1)
    assert set(d.intensity_sign.unique().tolist()) == {-1.0, 1.0}
    off = td.draw_augmentation(torch.Generator().manual_seed(0), 8, 32, 32, 1,
                               td.DeviceAugmentParams(rotation=False, reflection=False,
                                                      jitter_severity=0.0,
                                                      scale_severity=0.0))
    assert not off.theta.any() and not off.refl_x.any() and not off.tx.any()
    assert (off.sx == 1).all()


def test_augment_batch_end_to_end_with_a_generator():
    imgs, msks = _raw(3, 32, 32, 1, 5)
    g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
    a = td.augment_and_preprocess_batch(g1, torch.from_numpy(imgs.astype(np.int32)),
                                        torch.from_numpy(msks))
    b = td.augment_and_preprocess_batch(g2, torch.from_numpy(imgs.astype(np.int32)),
                                        torch.from_numpy(msks))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].shape == (3, 32, 32, 1) and a[1].shape == (3, 32, 32, 2)
    assert torch.isfinite(a[0]).all() and (a[1].sum(-1) == 1).all()
