"""The record codec: one (image, mask) pair <-> one ``ImageMaskPair``.

The port's own copy of ``serialize_image_mask_pair`` and
``deserialize_image_mask_pair`` from ``tpuseg/data/build_db.py`` (reference
build_lmdb.py:29-60, imagereader.py:269-281). The JAX package goes through
``google.protobuf``; the port encodes and decodes the message's wire format
by hand, so it needs no protobuf package. The schema is
``tpuseg/data/isg_ai.proto`` (proto2):

    1 channels int32 | 2 img_height int32 | 3 img_width int32
    4 img_type string | 5 mask_type string
    6 image bytes | 7 mask bytes | 8 labels bytes

The serializer sets all eight fields, and proto2 writes every field that
is set (even at its default value), in field-number order: the bytes equal
``ImageMaskPair.SerializeToString()``'s. The decoder reads any valid
encoding of the message (fields in any order, the last occurrence wins,
unknown fields skipped).

The folder-tiling database builder waits for a later slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

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
