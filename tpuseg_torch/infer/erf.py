"""Empirical receptive field (ERF) radius probe.

Counterpart of ``tpuseg/infer/erf.py`` (reference ``UNet.estimate_radius``,
model.py:165-202): feed Gaussian noise, build a Dirac-at-center MAE loss
against the model's own (frozen) softmax output, take the gradient **with
respect to the input image** through autograd, and measure the spatial
support of that gradient. The measured radius sets the tiled-inference
halo (inference.py:54-58).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpuseg_torch import RADIUS, SIZE_FACTOR


def _round_radius(x: float) -> int:
    """Round up to the next multiple of SIZE_FACTOR (model.py:160-163)."""
    return int(SIZE_FACTOR * np.ceil(float(x) / SIZE_FACTOR))


def estimate_radius(
    model: torch.nn.Module,
    num_channels: int,
    rng: Optional[np.random.Generator] = None,
    eps: float = 1e-8,
) -> int:
    """Measure the ERF radius of the eval-mode ``model`` (on its own
    device); falls back to the theoretical RADIUS=96 when the gradient
    support is degenerate (model.py:195-197). The noise comes from the
    numpy ``rng``, as in the JAX package, so both probes see one image."""
    n = 2 * RADIUS
    if rng is None:
        rng = np.random.default_rng()
    device = next(model.parameters()).device
    noise = rng.normal(size=(1, n, n, num_channels)).astype(np.float32)
    img = torch.from_numpy(noise).to(device).requires_grad_(True)
    mid = n // 2

    softmax = torch.softmax(model(img), dim=-1)
    # desired pattern: softmax with the center pixel's probabilities
    # flipped to 1-p (model.py:179-181), treated as a constant target
    target = softmax.detach().clone()
    target[0, mid, mid, :] = 1.0 - target[0, mid, mid, :]
    # Keras MAE(reduction=NONE) -> per-pixel mean over classes; the tape
    # gradient of the non-scalar sums it
    loss = torch.sum(torch.mean(torch.abs(target - softmax), dim=-1))
    (grads,) = torch.autograd.grad(loss, img)
    grad_img = np.abs(grads[0].float().cpu().numpy())  # H, W, C
    if num_channels > 1:
        grad_img = grad_img.mean(axis=-1)
    else:
        grad_img = grad_img.squeeze(-1)

    print(f"Theoretical RF: {RADIUS}")
    vec = np.maximum(grad_img.max(axis=0), grad_img.max(axis=1))
    idx = np.nonzero(vec > eps)[0]
    if len(idx) < 2:
        radius = RADIUS
        print(f"ERF based radius detection failed, defaulting to theoretical radius: {radius}")
    else:
        erf = int((idx.max() - idx.min()) / 2)
        radius = _round_radius(erf)
        print(f'computed radius : "{radius}"')
    return radius
