"""Image file IO (the port's own copy of ``tpuseg/utils/imagio.py``).

imageio (with a cv2 fallback) reads the reference's formats, including
16-bit single-channel TIFF. TIFF masks are written as tiled
deflate-compressed BigTIFF through :mod:`tpuseg_torch.utils.bigtiff`,
matching the reference's ``imsave(..., compress=6, bigtiff=True,
tile=(1024,1024))`` (inference.py:221-222).
"""

from __future__ import annotations

import numpy as np

from tpuseg_torch.utils import bigtiff


def imread(fp: str) -> np.ndarray:
    """Read an image preserving dtype and channel count (HW or HWC)."""
    try:
        if bigtiff.is_bigtiff(fp):
            # Pillow (imageio's TIFF backend) cannot parse BigTIFF
            return bigtiff.read_bigtiff(fp)
    except (OSError, IOError):
        pass
    try:
        import imageio.v3 as iio

        return np.asarray(iio.imread(fp))
    except Exception:
        import cv2

        img = cv2.imread(fp, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"cannot read image: {fp}")
        # cv2 returns BGR(A); flip to the RGB(A) order imageio yields
        if img.ndim == 3 and img.shape[2] == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        elif img.ndim == 3 and img.shape[2] == 4:
            img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA)
        return img


def imwrite(fp: str, img: np.ndarray, tile=(1024, 1024), compress_level: int = 6) -> None:
    """Write an image. TIFF output is tiled deflate BigTIFF per the
    reference mask-save contract (inference.py:221-222); other formats go
    through imageio."""
    if fp.lower().endswith((".tif", ".tiff")):
        bigtiff.write_bigtiff(fp, np.asarray(img), tile=tile, level=compress_level)
        return
    import imageio.v3 as iio

    iio.imwrite(fp, img)
