"""Host-side z-score statistics (imagereader.py:33-66).

The port's own copy of ``zscore_stats`` from ``tpuseg/data/preprocess.py``;
the normalization itself runs fused on the device (``infer/tiled.py``).
"""

from __future__ import annotations

import numpy as np


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
