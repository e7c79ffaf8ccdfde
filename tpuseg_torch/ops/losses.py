"""Loss and metric ops with the reference's TF/Keras semantics.

Counterpart of ``tpuseg/ops/losses.py`` (see there for the reference lines):
the training loss takes **logits** through an exact float32
``log_softmax`` (what Keras runs in graph mode); :func:`cce_from_probs`
keeps the Keras eager form (renormalize, clip at 1e-7, log) for parity
tests. Tensors are NHWC: the class axis is last.
"""

from __future__ import annotations

import torch

_KERAS_EPSILON = 1e-7  # tf.keras.backend.epsilon()


def smooth_labels(labels: torch.Tensor, label_smoothing: float) -> torch.Tensor:
    """Keras label smoothing: y*(1-s) + s/num_classes."""
    if label_smoothing:
        num_classes = labels.shape[-1]
        labels = labels * (1.0 - label_smoothing) + label_smoothing / num_classes
    return labels


def cce_from_logits(logits: torch.Tensor, labels_onehot: torch.Tensor,
                    label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-pixel categorical cross-entropy [N,H,W] from raw logits."""
    labels = smooth_labels(labels_onehot.float(), label_smoothing)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.sum(labels * logp, dim=-1)


def cce_from_probs(probs: torch.Tensor, labels_onehot: torch.Tensor,
                   label_smoothing: float = 0.0) -> torch.Tensor:
    """Keras-exact per-pixel CCE from probabilities (renormalize, clip, log)."""
    labels = smooth_labels(labels_onehot.float(), label_smoothing)
    p = probs.float()
    p = p / torch.sum(p, dim=-1, keepdim=True)
    p = torch.clamp(p, _KERAS_EPSILON, 1.0 - _KERAS_EPSILON)
    return -torch.sum(labels * torch.log(p), dim=-1)


def reference_scalar_loss(per_pixel: torch.Tensor, global_batch_size: int) -> torch.Tensor:
    """model.py:213-215 scaling: sum over N / global batch, then mean over H,W."""
    loss = torch.sum(per_pixel, dim=0) / global_batch_size
    return torch.mean(loss)


def categorical_accuracy(logits_or_probs: torch.Tensor,
                         labels_onehot: torch.Tensor) -> torch.Tensor:
    """tf.keras.metrics.CategoricalAccuracy over all pixels; argmax takes
    the first maximum, so logits and probabilities agree."""
    pred = torch.argmax(logits_or_probs, dim=-1)
    true = torch.argmax(labels_onehot, dim=-1)
    return torch.mean((pred == true).float())
