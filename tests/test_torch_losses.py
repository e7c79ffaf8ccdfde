"""The port's losses and metrics (tpuseg_torch/ops/losses.py) against
tpuseg.ops.losses on the same seeded inputs, rtol 1e-6 (float32; the same
formulas, summed over two classes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.ops import losses as jl
from tpuseg_torch.ops import losses as tl
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _inputs(seed=0, shape=(2, 16, 24, 3)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, shape).astype(np.float32)
    labels = np.eye(shape[-1], dtype=np.float32)[rng.integers(0, shape[-1], shape[:-1])]
    return logits, labels


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_cce_from_logits(smoothing):
    logits, labels = _inputs()
    want = np.asarray(jl.cce_from_logits(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = tl.cce_from_logits(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("smoothing", [0.0, 0.2])
def test_cce_from_probs_with_keras_clip(smoothing):
    logits, labels = _inputs(1)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs[0, 0, 0] = [1.0, 0.0, 0.0]  # hits the 1e-7 clip
    probs = probs.astype(np.float32)
    want = np.asarray(jl.cce_from_probs(jnp.asarray(probs), jnp.asarray(labels), smoothing))
    got = tl.cce_from_probs(torch.from_numpy(probs), torch.from_numpy(labels), smoothing)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_reference_scalar_loss_and_accuracy():
    logits, labels = _inputs(2)
    logits[0, 0, 0] = [1.0, 1.0, 0.0]  # a tie: the first max wins in both
    per_pixel = np.array(jl.cce_from_logits(jnp.asarray(logits), jnp.asarray(labels)))
    want = float(jl.reference_scalar_loss(jnp.asarray(per_pixel), 4))
    got = tl.reference_scalar_loss(torch.from_numpy(per_pixel), 4).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    want = float(jl.categorical_accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    got = tl.categorical_accuracy(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_smooth_labels():
    _, labels = _inputs(3)
    for s in (0.0, 0.3):
        want = np.asarray(jl.smooth_labels(jnp.asarray(labels), s))
        got = tl.smooth_labels(torch.from_numpy(labels), s).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
