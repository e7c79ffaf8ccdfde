"""Host (CPU) augmentation — the reference-parity "golden path".

The port's own copy of ``tpuseg/aug/host.py`` (numpy and scipy only): the
readers run it for ``--device_augmentation 0``.

Re-implements ``UNet/augment.py`` semantics without skimage (absent here):

- rotation: uniform 0-360 deg CCW about the image center, bilinear, with
  np.pad-style 'reflect' boundary (augment.py:71-72, 163) — implemented via
  ``scipy.ndimage.affine_transform(mode='mirror')`` (scipy's 'mirror' IS
  numpy/skimage 'reflect');
- jitter/scale: a second affine pass applying translation (jitter_x/y int
  pixels, +-severity*dim*U) and corner-anchored scale (1 +- severity*U),
  matching ``warp(I, AffineTransform(translation, scale)._inv_matrix)``
  (augment.py:76-106, 165-167) — passing ``_inv_matrix`` as warp's inverse
  map applies the FORWARD transform to the image content;
- x/y reflection: Bernoulli(0.5) flips after the affines (augment.py:169-172);
- additive Gaussian noise: sigma ~ U(-m, m), m = severity * dynamic range
  (augment.py:114-123);
- Gaussian blur: sigma ~ U(-max, max) clipped at 0 (so blur applies w.p. 1/2),
  ``scipy.ndimage.gaussian_filter(img, sigma, mode='reflect')`` — note the
  reference filters the HWC array with a scalar sigma, blurring across the
  channel axis too; reproduced verbatim (augment.py:126-136);
- additive intensity shift: +-U(0, severity) * dynamic range (augment.py:138-149);
- the mask rides through the same affines then is rounded (augment.py:152-155).

Unlike the reference (global ``np.random``), every draw goes through an
explicit ``np.random.Generator`` so reader workers are seedable and
reproducible.  The on-device equivalent lives in ``tpuseg_torch.aug.device``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import scipy.ndimage


def _affine_inverse_rotation(theta_deg: float, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(matrix, offset) over (row, col) for the inverse map of a CCW rotation
    about the skimage center ((cols/2 - 0.5, rows/2 - 0.5))."""
    t = np.deg2rad(theta_deg)
    cos, sin = np.cos(t), np.sin(t)
    cy, cx = (h / 2.0 - 0.5), (w / 2.0 - 0.5)
    # inverse of screen-CCW rotation, in (row, col) coordinates
    m = np.array([[cos, sin], [-sin, cos]])
    center = np.array([cy, cx])
    offset = center - m @ center
    return m, offset


def _apply_affine(I: np.ndarray, matrix: np.ndarray, offset: np.ndarray) -> np.ndarray:
    """Bilinear affine resample with reflect (numpy-style) boundary; HW or HWC."""
    if I.ndim == 2:
        return scipy.ndimage.affine_transform(I, matrix, offset=offset, order=1, mode="mirror")
    m3 = np.eye(3)
    m3[:2, :2] = matrix
    o3 = np.array([offset[0], offset[1], 0.0])
    return scipy.ndimage.affine_transform(I, m3, offset=o3, order=1, mode="mirror")


def apply_affine_transformation(
    I: np.ndarray,
    orientation: float,
    reflect_x: bool,
    reflect_y: bool,
    jitter_x: int,
    jitter_y: int,
    scale_x: float,
    scale_y: float,
) -> np.ndarray:
    """Sequential rotate -> scale/translate -> flips (augment.py:160-174).

    The two resamples are kept sequential (not composed) to preserve the
    reference's boundary-reflection behavior exactly.
    """
    I = np.asarray(I, dtype=np.float64)
    if orientation != 0:
        m, off = _affine_inverse_rotation(orientation, I.shape[0], I.shape[1])
        I = _apply_affine(I, m, off)

    if jitter_x != 0 or jitter_y != 0 or scale_x != 1 or scale_y != 1:
        # inverse of corner-anchored scale-then-translate: in = (out - t) / s
        m = np.array([[1.0 / scale_y, 0.0], [0.0, 1.0 / scale_x]])
        off = np.array([-jitter_y / scale_y, -jitter_x / scale_x])
        I = _apply_affine(I, m, off)

    if reflect_x:
        I = np.fliplr(I)
    if reflect_y:
        I = np.flipud(I)
    return I


def augment_image(
    img: np.ndarray,
    mask: Optional[np.ndarray] = None,
    rotation_flag: bool = False,
    reflection_flag: bool = False,
    jitter_augmentation_severity: Optional[float] = 0,
    noise_augmentation_severity: Optional[float] = 0,
    scale_augmentation_severity: Optional[float] = 0,
    blur_augmentation_max_sigma: Optional[float] = 0,
    intensity_augmentation_severity: Optional[float] = 0,
    rng: Optional[np.random.Generator] = None,
    worst_case: bool = False,
) -> Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]:
    """Reference ``augment_image`` (augment.py:19-157) with seedable RNG.

    ``worst_case`` replaces the reference's hard-coded
    ``debug_worst_possible_transformation`` flag (augment.py:31).
    """
    if rng is None:
        rng = np.random.default_rng()

    img = np.asarray(img, dtype=np.float32)
    assert img.ndim in (2, 3)
    jitter_augmentation_severity = jitter_augmentation_severity or 0
    noise_augmentation_severity = noise_augmentation_severity or 0
    scale_augmentation_severity = scale_augmentation_severity or 0
    blur_augmentation_max_sigma = blur_augmentation_max_sigma or 0
    intensity_augmentation_severity = intensity_augmentation_severity or 0
    assert 0 <= jitter_augmentation_severity < 1
    assert 0 <= noise_augmentation_severity < 1
    assert 0 <= scale_augmentation_severity < 1
    assert 0 <= intensity_augmentation_severity < 1

    h, w = img.shape[0], img.shape[1]
    if img.ndim == 2:
        img = img[..., None]

    if mask is not None:
        mask = np.asarray(mask, dtype=np.float32)
        assert mask.ndim in (2, 3)
        assert mask.shape[0] == h and mask.shape[1] == w

    orientation = 0.0
    reflect_x = reflect_y = False
    jitter_x = jitter_y = 0
    scale_x = scale_y = 1.0

    if rotation_flag:
        orientation = 360 * rng.random()
    if reflection_flag:
        reflect_x = rng.random() > 0.5
        reflect_y = rng.random() > 0.5
    if jitter_augmentation_severity > 0:
        amp = 1.0 if worst_case else rng.random()
        jitter_x = int(jitter_augmentation_severity * w * amp)
        if rng.random() > 0.5:
            jitter_x = -jitter_x
        amp = 1.0 if worst_case else rng.random()
        jitter_y = int(jitter_augmentation_severity * h * amp)
        if rng.random() > 0.5:
            jitter_y = -jitter_y
    if scale_augmentation_severity > 0:
        lo, hi = 1 - scale_augmentation_severity, 1 + scale_augmentation_severity
        scale_x = hi if worst_case else lo + (hi - lo) * rng.random()
        scale_y = hi if worst_case else lo + (hi - lo) * rng.random()

    img = apply_affine_transformation(img, orientation, reflect_x, reflect_y,
                                      jitter_x, jitter_y, scale_x, scale_y)
    if mask is not None:
        mask = apply_affine_transformation(mask, orientation, reflect_x, reflect_y,
                                           jitter_x, jitter_y, scale_x, scale_y)

    if noise_augmentation_severity > 0:
        sigma_max = noise_augmentation_severity * (np.max(img) - np.min(img))
        sigma = sigma_max if worst_case else -sigma_max + 2 * sigma_max * rng.random()
        img = img + rng.standard_normal(img.shape) * sigma

    if blur_augmentation_max_sigma > 0:
        mx = blur_augmentation_max_sigma
        sigma = mx if worst_case else -mx + 2 * mx * rng.random()
        if sigma > 0:
            # reference blurs the raw HWC array with scalar sigma: the channel
            # axis is blurred too (augment.py:136) — kept for parity
            img = scipy.ndimage.gaussian_filter(img, sigma, mode="reflect")

    if intensity_augmentation_severity > 0:
        img_range = np.max(img) - np.min(img)
        value = (1.0 if worst_case else rng.random()) * intensity_augmentation_severity * img_range
        sign = 1.0 if rng.random() > 0.5 else -1.0
        img = img + sign * value

    img = np.asarray(img, dtype=np.float32)
    if mask is not None:
        mask = np.round(np.asarray(mask, dtype=np.float32))
        return img, mask
    return img
