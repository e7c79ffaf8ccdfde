"""Dataset builder: folders of image/mask files -> train/test record stores,
and the record codec (one (image, mask) pair <-> one ``ImageMaskPair``).

The port's own copy of ``tpuseg/data/build_db.py`` (reference
``UNet/build_lmdb.py``): the same seeded train/test split, tiling grid
(stride ``tile_size - RADIUS``, slide-to-fit edges, duplicate boxes
dropped), keys ``{name}_i{y}_j{x}:{classes}`` or ``{name}:{classes}``, and
record bytes, so both packages build the same databases from one folder.
Tiled-BigTIFF pairs tile straight from disk without being loaded whole.

The JAX package goes through ``google.protobuf``; the port encodes and
decodes the message's wire format by hand, so it needs no protobuf
package. The schema is
``tpuseg/data/isg_ai.proto`` (proto2):

    1 channels int32 | 2 img_height int32 | 3 img_width int32
    4 img_type string | 5 mask_type string
    6 image bytes | 7 mask bytes | 8 labels bytes

The serializer sets all eight fields, and proto2 writes every field that
is set (even at its default value), in field-number order: the bytes equal
``ImageMaskPair.SerializeToString()``'s. The decoder reads any valid
encoding of the message (fields in any order, the last occurrence wins,
unknown fields skipped).
"""

from __future__ import annotations

import os
import random
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpuseg_torch import RADIUS, SIZE_FACTOR
from tpuseg_torch.data.recordstore import RecordWriter
from tpuseg_torch.utils.bigtiff import BigTiffReader, is_bigtiff
from tpuseg_torch.utils.imagio import imread

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
_INT_FIELDS = {1: "channels", 2: "img_height", 3: "img_width"}
_LEN_FIELDS = {4: "img_type", 5: "mask_type", 6: "image", 7: "mask", 8: "labels"}


def _varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # int32 negatives are sign-extended to 10 bytes
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("truncated varint in ImageMaskPair record")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long in ImageMaskPair record")


def encode_image_mask_pair(fields: Dict[str, object]) -> bytes:
    """The message's wire bytes: ints as varints, strings as UTF-8, all
    fields present in ``fields`` written in field-number order."""
    out = bytearray()
    for num in range(1, 9):
        if num in _INT_FIELDS:
            name = _INT_FIELDS[num]
            if name in fields:
                out += _varint((num << 3) | _VARINT) + _varint(int(fields[name]))
        else:
            name = _LEN_FIELDS[num]
            if name in fields:
                val = fields[name]
                val = val.encode("utf-8") if isinstance(val, str) else bytes(val)
                out += _varint((num << 3) | _LEN) + _varint(len(val)) + val
    return bytes(out)


def decode_image_mask_pair(buf: bytes) -> Dict[str, object]:
    """Parse the wire bytes into a dict with every field (absent ones at
    their defaults: 0, "" or b"")."""
    mv = memoryview(buf)
    out: Dict[str, object] = {name: 0 for name in _INT_FIELDS.values()}
    out.update(img_type="", mask_type="", image=b"", mask=b"", labels=b"")
    pos = 0
    while pos < len(mv):
        tag, pos = _read_varint(mv, pos)
        num, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            val, pos = _read_varint(mv, pos)
            if num in _INT_FIELDS:
                val &= 0xFFFFFFFF  # int32 from its (possibly 64-bit) varint
                out[_INT_FIELDS[num]] = val - (1 << 32) if val >= 1 << 31 else val
        elif wire == _LEN:
            length, pos = _read_varint(mv, pos)
            if pos + length > len(mv):
                raise ValueError("truncated field in ImageMaskPair record")
            val = mv[pos:pos + length]
            pos += length
            if num in (4, 5):
                out[_LEN_FIELDS[num]] = bytes(val).decode("utf-8")
            elif num in _LEN_FIELDS:
                out[_LEN_FIELDS[num]] = val
        elif wire == _I64:
            pos += 8
        elif wire == _I32:
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire} in ImageMaskPair record")
    if pos != len(mv):
        raise ValueError("truncated ImageMaskPair record")
    return out


def serialize_image_mask_pair(img: np.ndarray, msk: np.ndarray) -> bytes:
    """Encode one (image, mask) pair as the wire-compatible record
    (reference write_img_to_db, build_lmdb.py:29-60)."""
    if not isinstance(img, np.ndarray) or not isinstance(msk, np.ndarray):
        raise TypeError("Img must be numpy array to store into db")
    if img.ndim > 3 or img.ndim < 2:
        raise ValueError("Img must be 2D or 3D [HW, or HWC] format")
    if img.ndim == 2:
        img = img.reshape((img.shape[0], img.shape[1], 1))
    return encode_image_mask_pair({
        "channels": img.shape[2],
        "img_height": img.shape[0],
        "img_width": img.shape[1],
        "img_type": img.dtype.str,
        "mask_type": msk.dtype.str,
        "image": img.tobytes(),
        "mask": msk.tobytes(),
        "labels": np.unique(msk).tobytes(),
    })


def deserialize_image_mask_pair(buf: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a record back to (image HWC, mask HW) numpy arrays
    (reference decode, imagereader.py:269-281). The arrays view ``buf``."""
    d = decode_image_mask_pair(buf)
    img = np.frombuffer(d["image"], dtype=np.dtype(d["img_type"]))
    img = img.reshape((d["img_height"], d["img_width"], d["channels"]))
    msk = np.frombuffer(d["mask"], dtype=np.dtype(d["mask_type"]))
    msk = msk.reshape((d["img_height"], d["img_width"]))
    return img, msk


def enforce_size_multiple(img: np.ndarray) -> np.ndarray:
    """Center-crop H,W down to multiples of 16 (build_lmdb.py:63-79)."""
    h, w = img.shape[0], img.shape[1]
    tgt_h = (h // SIZE_FACTOR) * SIZE_FACTOR
    tgt_w = (w // SIZE_FACTOR) * SIZE_FACTOR
    dh, dw = h - tgt_h, w - tgt_w
    img = img[dh // 2:, dw // 2:]
    return img[:tgt_h, :tgt_w]


def _present_classes_str(msk: np.ndarray) -> str:
    return ",".join(str(c) for c in np.unique(msk))


def tiling_boxes(height: int, width: int, tile_size: int) -> List[Tuple[int, int, int, int]]:
    """(y_st, x_st, y_end, x_end) boxes: stride ``tile_size - RADIUS``, edge
    boxes slid inward to fit, in the reference's column-major emission order
    (build_lmdb.py:82-126)."""
    delta = int(tile_size - RADIUS)
    boxes = []
    seen = set()
    for x_st in range(0, width, delta):
        for y_st in range(0, height, delta):
            x_end, y_end = x_st + tile_size, y_st + tile_size
            if x_end > width:
                x_st += width - x_end
                x_end = width
            if y_end > height:
                y_st += height - y_end
                y_end = height
            box = (y_st, x_st, y_end, x_end)
            # slide-to-fit can collapse several grid cells onto one box; the
            # reference's LMDB put overwrites same-key records, so keep one
            # (an append-only store would keep every copy and skew sampling
            # toward edge tiles)
            if box not in seen:
                seen.add(box)
                boxes.append(box)
    return boxes


def process_slide_tiling(
    img: np.ndarray, msk: np.ndarray, tile_size: int, block_key: str
) -> Tuple[List[np.ndarray], List[np.ndarray], List[str]]:
    """Overlapping tile grid over in-RAM arrays (build_lmdb.py:82-126)."""
    img_list, msk_list, key_list = [], [], []
    for y_st, x_st, y_end, x_end in tiling_boxes(img.shape[0], img.shape[1], tile_size):
        img_tile = img[y_st:y_end, x_st:x_end]
        msk_tile = msk[y_st:y_end, x_st:x_end]
        img_list.append(img_tile)
        msk_list.append(msk_tile)
        key_list.append(f"{block_key}_i{y_st}_j{x_st}:{_present_classes_str(msk_tile)}")
    return img_list, msk_list, key_list


def _stream_slide_tiling(writer: RecordWriter, img_path: str, msk_path: str, tile_size: int,
                         block_key: str, emitted: Optional[dict] = None) -> None:
    """Tile a whole-slide image/mask pair straight from tiled BigTIFF into
    the record store without loading either whole; keys and records equal
    the in-RAM path's. ``emitted["records"]`` counts the puts, so the caller
    can tell a failure before any write (safe to fall back) from one
    mid-stream (a fallback would duplicate the keys already written)."""
    with BigTiffReader(img_path) as ir, BigTiffReader(msk_path) as mr:
        if ir.height < tile_size or ir.width < tile_size:
            # slide-to-fit would need negative region starts, which
            # read_region rejects; IOError before any put routes the pair to
            # the in-RAM path, whose slicing handles sub-tile images
            raise IOError(
                f"slide {ir.height}x{ir.width} smaller than tile_size "
                f"{tile_size}; in-RAM path handles it: {img_path}")
        if (ir.height, ir.width) != (mr.height, mr.width):
            raise AssertionError(
                "Image and Mask must be the same Height, input images should be "
                "either HW or HWC dimension ordering")
        if mr.channels != 1:
            raise ValueError(
                f"mask must be grayscale, got {mr.channels} channels: {msk_path}")
        _check_mask_dtype(mr.dtype, msk_path)
        for y_st, x_st, y_end, x_end in tiling_boxes(ir.height, ir.width, tile_size):
            t = ir.read_region(y_st, x_st, y_end - y_st, x_end - x_st)
            m = mr.read_region(y_st, x_st, y_end - y_st, x_end - x_st)[..., 0]
            key = f"{block_key}_i{y_st}_j{x_st}:{_present_classes_str(m)}"
            writer.put(key, serialize_image_mask_pair(t, m))
            if emitted is not None:
                emitted["records"] = emitted.get("records", 0) + 1


def _check_mask_dtype(dtype, msk_path: str) -> None:
    """Masks must be integer class ids (uint8/uint16/int32): float masks
    would build keys like 'name:0.0,1.0' that break the class-balanced
    sampler much later."""
    if np.dtype(dtype).kind not in "iu":
        raise ValueError(
            f"mask dtype must be an integer type (uint8/uint16/int32), got "
            f"{np.dtype(dtype)}: {msk_path}")


def generate_database(
    img_list: Sequence[str],
    database_name: str,
    image_filepath: str,
    mask_filepath: str,
    output_folder: str,
    tile_size: int,
) -> str:
    """Build one database directory from matched image/mask files
    (build_lmdb.py:129-188). Returns the database path. On any failure the
    writer is aborted and the directory removed: a finalized database
    holding only the records built so far would train without error."""
    db_dir = os.path.join(output_folder, database_name)
    if os.path.exists(db_dir):
        print("Deleting existing database")
        shutil.rmtree(db_dir)
    os.makedirs(db_dir)

    with open(os.path.join(db_dir, "img_filenames.csv"), "w") as csvfile:
        for fn in img_list:
            csvfile.write(fn + "\n")

    writer = RecordWriter(db_dir)
    try:
        for i, img_file_name in enumerate(img_list):
            print(f"  {i}/{len(img_list)}")
            block_key = os.path.splitext(img_file_name)[0]
            img_path = os.path.join(image_filepath, img_file_name)
            msk_path = os.path.join(mask_filepath, img_file_name)

            if tile_size > 0 and is_bigtiff(img_path) and is_bigtiff(msk_path):
                # whole-slide pair: tile straight from disk
                emitted: dict = {}
                try:
                    _stream_slide_tiling(writer, img_path, msk_path,
                                         tile_size, block_key, emitted)
                    continue
                except IOError:
                    # a BigTIFF dialect the reader rejects falls back to the
                    # in-RAM path (imread's backends) — but only before the
                    # first put, or the store would hold duplicate keys
                    if emitted.get("records"):
                        raise

            img = imread(img_path)
            # the mask keeps its dtype (uint8/uint16/int32, build_lmdb.py:51-52)
            msk = imread(msk_path)
            if msk.ndim == 3 and msk.shape[2] == 1:
                msk = msk[..., 0]
            if msk.ndim != 2:
                raise ValueError(
                    f"mask must be grayscale, got shape {msk.shape}: {msk_path}")
            _check_mask_dtype(msk.dtype, msk_path)
            if img.shape[0] != msk.shape[0]:
                raise AssertionError(
                    "Image and Mask must be the same Height, input images should be "
                    "either HW or HWC dimension ordering")
            if img.shape[1] != msk.shape[1]:
                raise AssertionError(
                    "Image and Mask must be the same Width, input images should be "
                    "either HW or HWC dimension ordering")

            if tile_size > 0:
                tiles, mtiles, keys = process_slide_tiling(img, msk, tile_size, block_key)
                for t, m, k in zip(tiles, mtiles, keys):
                    writer.put(k, serialize_image_mask_pair(t, m))
            else:
                img = enforce_size_multiple(img)
                msk = enforce_size_multiple(msk)
                key = f"{block_key}:{_present_classes_str(msk)}"
                writer.put(key, serialize_image_mask_pair(img, msk))
    except BaseException:
        try:
            writer.abort()
        finally:
            shutil.rmtree(db_dir, ignore_errors=True)
        raise
    writer.close()
    return db_dir


def build_databases(
    image_folder: str,
    mask_folder: str,
    output_folder: str,
    dataset_name: str,
    train_fraction: float = 0.8,
    image_format: str = "tif",
    use_tiling: bool = False,
    tile_size: int = 512,
    seed: Optional[int] = None,
) -> Tuple[str, str]:
    """Reference main() (build_lmdb.py:191-230): shuffle the mask folder's
    files with ``random.Random(seed)``, split at ``train_fraction`` and
    build ``train-{name}.lmdb`` and ``test-{name}.lmdb``."""
    if not use_tiling:
        tile_size = 0
    elif tile_size % SIZE_FACTOR:
        raise ValueError("UNet requires tiles with shapes that are multiples of 16")

    image_format = image_format.lstrip(".")
    image_folder = os.path.abspath(image_folder)
    mask_folder = os.path.abspath(mask_folder)
    output_folder = os.path.abspath(output_folder)
    os.makedirs(output_folder, exist_ok=True)

    img_files = [f for f in os.listdir(mask_folder) if f.endswith(f".{image_format}")]
    if len(img_files) == 0:
        raise RuntimeError("Found no images")

    rng = random.Random(seed)
    rng.shuffle(img_files)
    idx = int(train_fraction * len(img_files))
    train_img_files = img_files[:idx]
    test_img_files = img_files[idx:]

    print("building train database")
    train_db = generate_database(
        train_img_files, f"train-{dataset_name}.lmdb", image_folder, mask_folder,
        output_folder, tile_size)
    print("building test database")
    test_db = generate_database(
        test_img_files, f"test-{dataset_name}.lmdb", image_folder, mask_folder,
        output_folder, tile_size)
    return train_db, test_db
