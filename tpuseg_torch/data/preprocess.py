"""Host-side sample preprocessing: z-score normalization and one-hot labels.

The port's own copy of ``tpuseg/data/preprocess.py`` (imagereader.py:33-66
and :302-312): the readers' host path uses ``zscore_normalize`` and
``one_hot_labels``; serving computes ``zscore_stats`` on the host and
normalizes on the device (``infer/tiled.py``).
"""

from __future__ import annotations

import numpy as np


def zscore_normalize(image_data: np.ndarray, channels_first: bool = True) -> np.ndarray:
    """Per-channel z-score; channels with std <= 1 are only mean-shifted
    (the reference's divide-by-zero guard, imagereader.py:44-49)."""
    image_data = image_data.astype(np.float32)

    if image_data.ndim == 3:
        if not channels_first:
            image_data = image_data.transpose((2, 0, 1))
        for c in range(image_data.shape[0]):
            std = np.std(image_data[c])
            mv = np.mean(image_data[c])
            if std <= 1.0:
                image_data[c] = image_data[c] - mv
            else:
                image_data[c] = (image_data[c] - mv) / std
        if not channels_first:
            image_data = image_data.transpose((1, 2, 0))
    elif image_data.ndim == 2:
        std = np.std(image_data)
        mv = np.mean(image_data)
        if std <= 1.0:
            image_data = image_data - mv
        else:
            image_data = (image_data - mv) / std
    else:
        raise IOError(
            "Input to Z-Score normalization needs to be either a 2D or 3D image [HW, or CHW]")
    return image_data


def zscore_stats(image_data: np.ndarray) -> "tuple[np.ndarray, np.ndarray]":
    """Per-channel (mean, std) of an HW or HWC image, with the reductions
    the reference's ``zscore_normalize`` uses, so that ``(x - mean) / std``
    with the std<=1 mean-shift-only guard applied on the device reproduces
    it bit-for-bit in float32.
    """
    x = image_data.astype(np.float32)
    if x.ndim == 2:
        return (np.asarray([np.mean(x)], np.float32),
                np.asarray([np.std(x)], np.float32))
    if x.ndim != 3:
        raise IOError(
            "Input to Z-Score normalization needs to be either a 2D or 3D image [HW, or CHW]")
    x = x.transpose((2, 0, 1))
    mean = np.asarray([np.mean(x[c]) for c in range(x.shape[0])], np.float32)
    std = np.asarray([np.std(x[c]) for c in range(x.shape[0])], np.float32)
    return mean, std


def one_hot_labels(mask: np.ndarray, num_classes: int) -> np.ndarray:
    """HW int mask -> HWC one-hot int32 (imagereader.py:302-312); raises on
    out-of-range labels with the reference's class-mismatch message."""
    mask = mask.astype(np.int32)
    if mask.min() < 0 or mask.max() >= num_classes:
        raise IndexError(
            "ImageReader Error: Number of classes specified differs from number "
            "of observed classes in data")
    flat = mask.reshape(-1)
    out = np.zeros((flat.size, num_classes), dtype=np.int32)
    out[np.arange(flat.size), flat] = 1
    return out.reshape(mask.shape + (num_classes,))
