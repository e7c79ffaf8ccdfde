"""Minimal native BigTIFF tiled writer/reader.

The port's own copy of ``tpuseg/utils/bigtiff.py`` (the port imports
nothing of ``tpuseg``); keep the two in step.

The reference saves large inference masks as tiled, deflate-compressed
BigTIFF (``skimage.io.imsave(..., bigtiff=True, tile=(1024,1024),
compress=6)``, reference UNet/inference.py:221-222) so whole-slide
masks larger than the 4 GiB classic-TIFF limit remain writable. Pillow
writes classic TIFF only, so this module implements the format directly.

Scope: single-image grayscale or interleaved-multichannel BigTIFF, tiled,
Adobe-deflate (zlib) compressed — exactly the shape of the masks the
inference engine emits (uint8/uint16/int32, inference.py:215-220). The
reader handles everything the writer produces (plus uncompressed tiles)
and is used as the fallback for formats Pillow/cv2 cannot parse.

Format reference: TIFF 6.0 spec + the BigTIFF (version 43) extension:
16-byte header, 8-byte offsets, 20-byte IFD entries.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

BIGTIFF_MAGIC = b"II+\x00"  # little-endian, version 43

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259  # 1 = none, 8 = adobe deflate
_PHOTOMETRIC = 262  # 1 = BlackIsZero
_SAMPLES_PER_PIXEL = 277
_PLANAR_CONFIG = 284  # 1 = chunky (interleaved)
_PREDICTOR = 317  # 1 = none (2 = horizontal differencing, unsupported)
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325
_SAMPLE_FORMAT = 339  # 1 = uint, 2 = int, 3 = float

_TYPE_SHORT = 3  # u16
_TYPE_LONG8 = 16  # u64

_SAMPLE_FORMATS = {"u": 1, "i": 2, "f": 3}
_FORMAT_DTYPES = {(1, 8): np.uint8, (1, 16): np.uint16, (1, 32): np.uint32,
                  (2, 8): np.int8, (2, 16): np.int16, (2, 32): np.int32,
                  (3, 32): np.float32, (3, 64): np.float64}


def is_bigtiff(fp: str) -> bool:
    with open(fp, "rb") as f:
        return f.read(4) == BIGTIFF_MAGIC


def write_bigtiff(fp: str, img: np.ndarray, tile: Tuple[int, int] = (1024, 1024),
                  compression: str = "deflate", level: int = 6) -> None:
    """Write ``img`` (HW or HWC) as a tiled BigTIFF.

    ``level=6`` matches the reference's ``compress=6`` (inference.py:222).
    """
    img = np.ascontiguousarray(img)
    if img.ndim not in (2, 3):
        raise ValueError(f"BigTIFF writer expects HW or HWC, got {img.shape}")
    th, tw = tile
    with BigTiffTileWriter(fp, img.shape, img.dtype, tile=tile,
                           compression=compression, level=level) as w:
        # row-major over the tile grid; edge tiles crop to the valid area
        # (the writer zero-pads them to full tile size per the TIFF spec)
        for ty in range(w.tiles_down):
            for tx in range(w.tiles_across):
                w.put_tile(img[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw])


def _read_ifd(f) -> Dict[int, Tuple[int, int, int]]:
    (n,) = struct.unpack("<Q", f.read(8))
    entries = {}
    for _ in range(n):
        tag, typ, count, value = struct.unpack("<HHQQ", f.read(20))
        entries[tag] = (typ, count, value)
    return entries


def _tag_array(f, entry) -> np.ndarray:
    typ, count, value = entry
    size = {_TYPE_SHORT: 2, _TYPE_LONG8: 8, 4: 4}[typ]
    fmt = {_TYPE_SHORT: "H", _TYPE_LONG8: "Q", 4: "I"}[typ]
    if count * size <= 8:
        # inline little-endian packing of the value field
        raw = struct.pack("<Q", value)[:count * size]
    else:
        f.seek(value)
        raw = f.read(count * size)
    return np.frombuffer(raw, f"<{fmt}")


class BigTiffReader:
    """Random-access region reader for (single-image, tiled) BigTIFF —
    grayscale or chunky multichannel, deflate or uncompressed.

    Only the tiles overlapping a requested region are read and
    decompressed, so images far larger than host RAM stream in
    window-sized pieces (the streaming whole-slide inference path). A
    small LRU of decoded tiles serves the overlap between consecutive
    halo windows of a row-major sweep.
    """

    def __init__(self, fp: str, tile_cache: int = 64):
        self._fp = fp
        self._f = open(fp, "rb")
        try:
            self._parse_header(fp)
        except IOError:
            self._f.close()
            raise
        except BaseException as e:
            # malformed structures surface as struct.error / KeyError etc. —
            # normalize to IOError so callers' imread fallbacks engage
            self._f.close()
            if isinstance(e, Exception):
                raise IOError(f"malformed BigTIFF {fp}: {e}") from e
            raise
        self._cache: "Dict[int, np.ndarray]" = {}  # insertion-ordered LRU
        self._cache_max = tile_cache

    def _parse_header(self, fp: str) -> None:
        f = self._f
        if f.read(4) != BIGTIFF_MAGIC:
            raise IOError(f"not a little-endian BigTIFF: {fp}")
        _, _, ifd_offset = struct.unpack("<HHQ", f.read(12))
        f.seek(ifd_offset)
        tags = _read_ifd(f)

        def scalar(tag, default=None):
            if tag not in tags:
                if default is None:
                    raise IOError(f"BigTIFF missing required tag {tag}: {fp}")
                return default
            return int(_tag_array(f, tags[tag])[0])

        if any(t not in tags for t in (_TILE_WIDTH, _TILE_LENGTH,
                                       _TILE_OFFSETS, _TILE_BYTE_COUNTS)):
            raise IOError(f"BigTIFF is not tiled (strip layout unsupported): {fp}")
        self.width, self.height = scalar(_IMAGE_WIDTH), scalar(_IMAGE_LENGTH)
        if _BITS_PER_SAMPLE in tags:
            bits_arr = _tag_array(f, tags[_BITS_PER_SAMPLE])
            if len(set(int(b) for b in bits_arr)) > 1:
                raise IOError(
                    f"per-channel BitsPerSample {list(bits_arr)} unsupported: {fp}")
        bits = scalar(_BITS_PER_SAMPLE, 8)
        self._comp = scalar(_COMPRESSION, 1)
        self.channels = scalar(_SAMPLES_PER_PIXEL, 1)
        # decoding a predictor-2/3 file as plain deflate, or a planar file
        # as interleaved, would yield silently-wrong pixel values — raise
        # the IOError that engages callers' imread fallbacks, whose backends
        # handle those dialects correctly (review r3)
        predictor = scalar(_PREDICTOR, 1)
        if predictor != 1:
            raise IOError(f"unsupported TIFF predictor {predictor}: {fp}")
        if self.channels > 1 and scalar(_PLANAR_CONFIG, 1) != 1:
            raise IOError(
                f"planar (non-interleaved) multichannel TIFF unsupported: {fp}")
        self.tile_width, self.tile_height = scalar(_TILE_WIDTH), scalar(_TILE_LENGTH)
        fmt = scalar(_SAMPLE_FORMAT, 1)
        self.dtype = _FORMAT_DTYPES.get((fmt, bits))
        if self.dtype is None:
            raise IOError(f"unsupported sample format {(fmt, bits)}: {fp}")
        if self._comp not in (1, 8):
            raise IOError(f"unsupported compression {self._comp}: {fp}")
        self._offsets = _tag_array(f, tags[_TILE_OFFSETS])
        self._counts = _tag_array(f, tags[_TILE_BYTE_COUNTS])
        self.tiles_across = -(-self.width // self.tile_width)
        self.tiles_down = -(-self.height // self.tile_height)
        n_tiles = self.tiles_down * self.tiles_across
        if len(self._offsets) < n_tiles or len(self._counts) < n_tiles:
            # a corrupt-but-parsable short tag array would otherwise raise
            # IndexError later from _tile()/read_region, bypassing callers'
            # IOError-driven imread fallbacks (ADVICE r2)
            raise IOError(
                f"BigTIFF tile index shorter than the tile grid "
                f"({len(self._offsets)} offsets / {len(self._counts)} counts "
                f"for {n_tiles} tiles): {fp}")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.channels == 1:
            return (self.height, self.width)
        return (self.height, self.width, self.channels)

    def set_cache_size(self, n_tiles: int) -> None:
        """Resize the decoded-tile LRU (callers whose access pattern spans
        more tiles than the default — e.g. sweeping a differently-tiled
        pair — avoid re-decoding by sizing it to one tile row)."""
        self._cache_max = max(1, int(n_tiles))
        while len(self._cache) > self._cache_max:
            self._cache.pop(next(iter(self._cache)))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _tile(self, idx: int) -> np.ndarray:
        """Decoded (th, tw, spp) tile block, LRU-cached. Decode failures
        (sparse tiles with offset 0 as GDAL emits, non-padded edge tiles,
        corrupt deflate streams) normalize to IOError — the documented
        foreign-dialect signal that engages callers' imread fallbacks; raw
        zlib.error/ValueError used to escape past them (review r3)."""
        block = self._cache.pop(idx, None)
        if block is None:
            try:
                self._f.seek(int(self._offsets[idx]))
                data = self._f.read(int(self._counts[idx]))
                if self._comp == 8:
                    data = zlib.decompress(data)
                block = np.frombuffer(data, self.dtype).reshape(
                    self.tile_height, self.tile_width, self.channels)
            except (zlib.error, ValueError) as e:
                raise IOError(f"cannot decode tile {idx}: {e}")
            if len(self._cache) >= self._cache_max:
                self._cache.pop(next(iter(self._cache)))
        self._cache[idx] = block  # (re-)insert as most recent
        return block

    def iter_tiles(self):
        """Yield every decoded tile block once, row-major, valid-area
        cropped — the single-pass statistics sweep."""
        for idx in range(len(self._offsets)):
            ty, tx = divmod(idx, self.tiles_across)
            block = self._tile(idx)
            vh = min(self.tile_height, self.height - ty * self.tile_height)
            vw = min(self.tile_width, self.width - tx * self.tile_width)
            yield block[:vh, :vw]

    def read_region(self, y0: int, x0: int, h: int, w: int) -> np.ndarray:
        """Return the HWC region [y0:y0+h, x0:x0+w], assembled from only the
        overlapping tiles. The region must lie inside the image."""
        if not (0 <= y0 and 0 <= x0 and y0 + h <= self.height and x0 + w <= self.width):
            raise ValueError(
                f"region {(y0, x0, h, w)} outside image {self.height}x{self.width}")
        out = np.empty((h, w, self.channels), self.dtype)
        th, tw = self.tile_height, self.tile_width
        for ty in range(y0 // th, -(-(y0 + h) // th)):
            for tx in range(x0 // tw, -(-(x0 + w) // tw)):
                block = self._tile(ty * self.tiles_across + tx)
                by, bx = ty * th, tx * tw
                ys, xs = max(y0, by), max(x0, bx)
                ye, xe = min(y0 + h, by + th), min(x0 + w, bx + tw)
                out[ys - y0:ye - y0, xs - x0:xe - x0] = \
                    block[ys - by:ye - by, xs - bx:xe - bx]
        return out

    def streaming_zscore_stats(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-channel (mean, std) in one pass over the tiles, float64
        accumulation. For images that fit in RAM, prefer
        ``tpuseg_torch.data.preprocess.zscore_stats`` (bit-identical to the
        reference's float32 reductions); this streaming variant is for
        images that don't — it is the *more* accurate computation of the
        same statistics (imagereader.py:33-66 semantics)."""
        s = np.zeros(self.channels, np.float64)
        s2 = np.zeros(self.channels, np.float64)
        n = 0
        for block in self.iter_tiles():
            b = block.astype(np.float64)
            s += b.sum(axis=(0, 1))
            s2 += (b * b).sum(axis=(0, 1))
            n += b.shape[0] * b.shape[1]
        mean = s / n
        var = np.maximum(s2 / n - mean * mean, 0.0)
        return mean.astype(np.float32), np.sqrt(var).astype(np.float32)


class BigTiffTileWriter:
    """Incremental tiled BigTIFF writer: accepts tiles one at a time in
    row-major grid order, so a stitched mask far larger than host RAM can
    be written as it is produced. :func:`write_bigtiff` is the whole-array
    convenience wrapper around this."""

    def __init__(self, fp: str, shape: Tuple[int, ...], dtype,
                 tile: Tuple[int, int] = (1024, 1024),
                 compression: str = "deflate", level: int = 6):
        if len(shape) == 2:
            self._h, self._w = shape
            self._spp = 1
        elif len(shape) == 3:
            self._h, self._w, self._spp = shape
        else:
            raise ValueError(f"BigTIFF writer expects HW or HWC shape, got {shape}")
        self._dtype = np.dtype(dtype)
        if self._dtype.kind not in _SAMPLE_FORMATS:
            raise ValueError(f"unsupported dtype {self._dtype}")
        self._th, self._tw = tile
        self._compress = compression == "deflate"
        self._level = level
        self.tiles_across = -(-self._w // self._tw)
        self.tiles_down = -(-self._h // self._th)
        self._offsets: list = []
        self._counts: list = []
        self._f = open(fp, "wb")
        # header: magic, offset size 8, pad, first-IFD offset (patched later)
        self._f.write(BIGTIFF_MAGIC + struct.pack("<HHQ", 8, 0, 0))

    def put_tile(self, block: np.ndarray) -> None:
        """Append the next row-major grid tile. Edge tiles may come cropped
        to the valid area; they are zero-padded to full tile size per the
        TIFF spec."""
        if len(self._offsets) >= self.tiles_across * self.tiles_down:
            raise ValueError("all tiles already written")
        block = np.asarray(block, self._dtype)
        block = block.reshape(block.shape[0], block.shape[1], self._spp)
        if block.shape[:2] != (self._th, self._tw):
            full = np.zeros((self._th, self._tw, self._spp), self._dtype)
            full[:block.shape[0], :block.shape[1]] = block
            block = full
        raw = np.ascontiguousarray(block).tobytes()
        data = zlib.compress(raw, self._level) if self._compress else raw
        f = self._f
        if f.tell() % 2:
            f.write(b"\x00")  # keep offsets word-aligned
        self._offsets.append(f.tell())
        self._counts.append(len(data))
        f.write(data)

    def close(self) -> None:
        f = self._f
        n_expected = self.tiles_across * self.tiles_down
        if len(self._offsets) != n_expected:
            f.close()
            raise ValueError(
                f"wrote {len(self._offsets)} of {n_expected} tiles before close")

        def write_array(values):
            if f.tell() % 2:
                f.write(b"\x00")
            pos = f.tell()
            f.write(struct.pack(f"<{len(values)}Q", *values))
            return pos

        if len(self._offsets) == 1:
            off_value, cnt_value = self._offsets[0], self._counts[0]
        else:
            off_value = write_array(self._offsets)
            cnt_value = write_array(self._counts)

        def short_array(vals):
            """(count, value) for a SHORT-array tag: inline if it fits the
            8-byte value field (spp <= 4 always does), external otherwise."""
            if len(vals) * 2 <= 8:
                packed = 0
                for i, v in enumerate(vals):
                    packed |= int(v) << (16 * i)
                return len(vals), packed
            if f.tell() % 2:
                f.write(b"\x00")
            pos = f.tell()
            f.write(struct.pack(f"<{len(vals)}H", *vals))
            return len(vals), pos

        # the TIFF spec requires count == SamplesPerPixel for these two —
        # count-1 multichannel files are flagged by strict libtiff readers
        bps_count, bps_value = short_array([self._dtype.itemsize * 8] * self._spp)
        fmt_count, fmt_value = short_array(
            [_SAMPLE_FORMATS[self._dtype.kind]] * self._spp)

        entries = [
            (_IMAGE_WIDTH, _TYPE_LONG8, 1, self._w),
            (_IMAGE_LENGTH, _TYPE_LONG8, 1, self._h),
            (_BITS_PER_SAMPLE, _TYPE_SHORT, bps_count, bps_value),
            (_COMPRESSION, _TYPE_SHORT, 1, 8 if self._compress else 1),
            (_PHOTOMETRIC, _TYPE_SHORT, 1, 1),
            (_SAMPLES_PER_PIXEL, _TYPE_SHORT, 1, self._spp),
            (_PLANAR_CONFIG, _TYPE_SHORT, 1, 1),
            (_TILE_WIDTH, _TYPE_SHORT, 1, self._tw),
            (_TILE_LENGTH, _TYPE_SHORT, 1, self._th),
            (_TILE_OFFSETS, _TYPE_LONG8, len(self._offsets), off_value),
            (_TILE_BYTE_COUNTS, _TYPE_LONG8, len(self._counts), cnt_value),
            (_SAMPLE_FORMAT, _TYPE_SHORT, fmt_count, fmt_value),
        ]
        if f.tell() % 2:
            f.write(b"\x00")
        ifd_offset = f.tell()
        f.write(struct.pack("<Q", len(entries)))
        for tag, typ, count, value in sorted(entries):
            f.write(struct.pack("<HHQQ", tag, typ, count, value))
        f.write(struct.pack("<Q", 0))  # no next IFD
        f.seek(8)
        f.write(struct.pack("<Q", ifd_offset))
        f.close()

    def abort(self) -> None:
        """Close the file handle without finalizing the IFD (error paths)."""
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        else:
            self.abort()


def read_bigtiff(fp: str) -> np.ndarray:
    """Read a whole (single-image, tiled or single-tile) BigTIFF written by
    :func:`write_bigtiff` — grayscale or chunky multichannel, deflate or
    uncompressed."""
    with BigTiffReader(fp, tile_cache=1) as r:
        out = r.read_region(0, 0, r.height, r.width)
    return out[..., 0] if out.shape[-1] == 1 else out
