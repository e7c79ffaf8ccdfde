"""TensorFlow's tensor bundle (the V2 checkpoint format) with numpy alone.

``tf.train.Checkpoint.write(prefix)`` leaves two kinds of file:

- ``<prefix>.index``: a LevelDB-format table. Keys are variable names in
  byte order; the value of the empty key is a ``BundleHeaderProto``
  (``num_shards``, endianness, version), every other value a
  ``BundleEntryProto`` (dtype, shape, shard, offset, size, masked CRC32C
  of the bytes). The table is data blocks of prefix-compressed keys with
  restart arrays, a metaindex block, an index block of block handles, and
  a 48-byte footer that ends in the magic ``0xdb4775248b80fb57``. Each
  block is followed by a compression byte and the masked CRC32C of the
  block and that byte.
- ``<prefix>.data-NNNNN-of-MMMMM``: the tensors' raw little-endian bytes.

:class:`BundleReader` parses both by hand (varints and the few proto
fields above) and checks every CRC it meets. It reads float32, int32 and
int64 tensors; string entries (such as
``_CHECKPOINTABLE_OBJECT_GRAPH``) are listed but not read. It refuses, with
an ``IOError``, a compressed block, a sliced (partitioned) entry, a
big-endian bundle and any CRC mismatch. :func:`write_bundle` writes the same
format for numeric tensors (one uncompressed data block, restart interval
1, no object graph), which TensorFlow's own reader reads.

:func:`crc32c` (Castagnoli) is vectorised with numpy, so a checkpoint of a
full-width U-Net (about 124 MB) is checked in well under a second; its
masked form (:func:`mask_crc`) is also what TFRecord framing uses
(``utils/tb_events.py``).
"""

from __future__ import annotations

import glob
import os
import re
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
FOOTER_SIZE = 48  # two block handles padded to 40 bytes, then the magic
BLOCK_TRAILER_SIZE = 5  # compression byte + masked CRC32C
HEADER_KEY = b""

# tensorflow/core/framework/types.proto
DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16", 6: "int8",
               7: "string", 9: "int64", 10: "bool", 14: "bfloat16", 19: "float16"}
_READABLE = {1: "<f4", 3: "<i4", 9: "<i8"}
_DT_CODES = {np.dtype(v).name: k for k, v in _READABLE.items()}

# --- CRC32C --------------------------------------------------------------

_POLY = 0x82F63B78  # Castagnoli, reflected
_MASK_DELTA = 0xA282EAD8


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_T0 = _byte_table()
# slicing-by-4: _SLICE[k][b] is the register after byte b and k zero bytes
_SLICE = [_T0]
for _ in range(3):
    _SLICE.append((_SLICE[-1] >> 8) ^ _T0[_SLICE[-1] & 0xFF])
_SLICE = np.stack(_SLICE[::-1])  # [T3, T2, T1, T0]: applied to bytes 0..3 of a word


def _apply(op: np.ndarray, v: np.ndarray) -> np.ndarray:
    """A linear map of the CRC register, as four byte tables, applied to
    every entry of ``v`` (uint32)."""
    return (op[0][v & 0xFF] ^ op[1][(v >> 8) & 0xFF] ^ op[2][(v >> 16) & 0xFF]
            ^ op[3][v >> 24])


def _zero_byte_op() -> np.ndarray:
    """The register map of one zero byte: s -> T[s & 0xFF] ^ (s >> 8)."""
    b = np.arange(256, dtype=np.uint32)
    s = np.stack([b << (8 * k) for k in range(4)])
    return (_T0[s & 0xFF] ^ (s >> 8)).astype(np.uint32)


_SHIFT_OPS: List[np.ndarray] = [_zero_byte_op()]  # [j]: 2^j zero bytes


def _shift(v: np.ndarray, nbytes: int) -> np.ndarray:
    """The register ``v`` carried through ``nbytes`` zero bytes."""
    j = 0
    while nbytes:
        while len(_SHIFT_OPS) <= j:
            op = _SHIFT_OPS[-1]
            _SHIFT_OPS.append(_apply(op, op))  # op after op: twice the length
        if nbytes & 1:
            v = _apply(_SHIFT_OPS[j], v)
        nbytes >>= 1
        j += 1
    return v


def _raw_crc(buf: np.ndarray) -> int:
    """The register after ``buf`` from a zero register (no pre- or
    post-inversion). Zero bytes put in front leave it unchanged, so the
    buffer is zero-padded in front to ``lanes`` equal chunks of whole
    words, each chunk's register runs slicing-by-4 in one numpy lane, and
    the chunks' registers are folded pairwise (``crc(A+B) = shift(crc(A),
    len(B)) ^ crc(B)``)."""
    words = -(-buf.size // 4)
    lanes = max(1, min(16384, words // 64))
    per_lane = -(-words // lanes)
    padded = np.zeros(lanes * per_lane * 4, np.uint8)
    padded[padded.size - buf.size:] = buf
    w = padded.view("<u4").reshape(lanes, per_lane)
    s = np.zeros(lanes, np.uint32)
    for j in range(per_lane):
        s = _apply(_SLICE, s ^ w[:, j])
    chunk = per_lane * 4
    while s.size > 1:
        if s.size % 2:
            s = np.concatenate([np.zeros(1, np.uint32), s])  # a zero chunk in front
        s = _shift(s[0::2], chunk) ^ s[1::2]
        chunk *= 2
    return int(s[0])


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(memoryview(data).cast("B"), np.uint8)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like or a numpy array's bytes), extending
    ``crc`` the way LevelDB's ``crc32c::Extend`` does
    (``crc32c(b + c) == crc32c(c, crc32c(b))``)."""
    buf = _as_bytes(data)
    start = np.array([crc ^ 0xFFFFFFFF], np.uint32)
    return (int(_shift(start, buf.size)[0]) ^ _raw_crc(buf)) ^ 0xFFFFFFFF


def mask_crc(crc: int) -> int:
    """LevelDB's and TFRecord's masked CRC: rotate right by 15, add a delta."""
    return (((crc >> 15) | (crc << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def unmask_crc(masked: int) -> int:
    rot = (masked - _MASK_DELTA) & 0xFFFFFFFF
    return ((rot >> 17) | (rot << 15)) & 0xFFFFFFFF


# --- varints and proto fields ---------------------------------------------

def _varint(buf, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(buf):
            raise IOError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise IOError("varint longer than 10 bytes")


def encode_varint(value: int) -> bytes:
    if value < 0:
        value += 1 << 64  # proto int64: two's complement, 10 bytes
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _int64(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def proto_fields(buf) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of each field of a serialized
    proto message: an int for varint and fixed fields, bytes for
    length-delimited ones."""
    buf = bytes(buf)
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, = struct.unpack_from("<Q", buf, pos)
            pos += 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value = buf[pos:pos + n]
            if len(value) != n:
                raise IOError("truncated length-delimited field")
            pos += n
        elif wire == 5:
            value, = struct.unpack_from("<I", buf, pos)
            pos += 4
        else:
            raise IOError(f"unsupported proto wire type {wire}")
        yield field, wire, value


def proto_key(field: int, wire: int) -> bytes:
    return encode_varint(field << 3 | wire)


def proto_bytes(field: int, payload: bytes) -> bytes:
    return proto_key(field, 2) + encode_varint(len(payload)) + payload


# --- the table ------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int, what: str) -> bytes:
    end = offset + size
    if end + BLOCK_TRAILER_SIZE > len(data):
        raise IOError(f"{what}: block at {offset} (+{size}) runs past the end of the file")
    block = data[offset:end]
    kind = data[end]
    stored, = struct.unpack_from("<I", data, end + 1)
    if kind != 0:
        raise IOError(f"{what}: block at {offset} is compressed (type {kind}); only "
                      "uncompressed tables are read")
    if unmask_crc(stored) != crc32c(data[offset:end + 1]):
        raise IOError(f"{what}: CRC32C mismatch in the block at {offset}")
    return block


def _block_entries(block: bytes, what: str) -> Iterator[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise IOError(f"{what}: block of {len(block)} bytes has no restart count")
    n_restarts, = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * n_restarts
    if limit < 0:
        raise IOError(f"{what}: restart array larger than its block")
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        if shared > len(key) or pos + non_shared + n_value > limit:
            raise IOError(f"{what}: corrupt block entry at {pos}")
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _handle(buf, pos: int = 0) -> Tuple[int, int, int]:
    offset, pos = _varint(buf, pos)
    size, pos = _varint(buf, pos)
    return offset, size, pos


def read_table(path: str) -> Dict[bytes, bytes]:
    """Every key and value of a LevelDB-format table file, in key order."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < FOOTER_SIZE:
        raise IOError(f"{path}: {len(data)} bytes is too short for a table")
    footer = data[-FOOTER_SIZE:]
    magic, = struct.unpack_from("<Q", footer, FOOTER_SIZE - 8)
    if magic != TABLE_MAGIC:
        raise IOError(f"{path}: bad table magic {magic:#018x}: not a TF checkpoint index")
    _, _, pos = _handle(footer)  # the metaindex (filters): not used
    index_offset, index_size, _ = _handle(footer, pos)
    out: Dict[bytes, bytes] = {}
    index = _read_block(data, index_offset, index_size, path)
    for _, handle in _block_entries(index, path):
        offset, size, _ = _handle(handle)
        for key, value in _block_entries(_read_block(data, offset, size, path), path):
            out[key] = value
    return out


# --- bundle entries -------------------------------------------------------

@dataclass(frozen=True)
class BundleEntry:
    """One tensor's ``BundleEntryProto``: ``dtype`` is TensorFlow's name
    for it (``float32``, ``int64``, ``string``, ...), ``crc32c`` the masked
    CRC as stored."""

    dtype: str
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc32c: Optional[int]
    dtype_code: int


def _shape(buf) -> Tuple[int, ...]:
    dims = []
    for field, _, value in proto_fields(buf):
        if field == 2:  # Dim
            size = 0
            for f, _, v in proto_fields(value):
                if f == 1:
                    size = _int64(v)
            dims.append(size)
        elif field == 3 and value:
            raise IOError("a tensor of unknown rank in a checkpoint entry")
    return tuple(dims)


def parse_entry(name: str, buf) -> BundleEntry:
    f = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0, "crc32c": None}
    for field, _, value in proto_fields(buf):
        if field == 1:
            f["dtype"] = value
        elif field == 2:
            f["shape"] = _shape(value)
        elif field == 3:
            f["shard_id"] = value
        elif field == 4:
            f["offset"] = _int64(value)
        elif field == 5:
            f["size"] = _int64(value)
        elif field == 6:
            f["crc32c"] = value
        elif field == 7:
            raise IOError(f"{name!r} is a sliced (partitioned) variable; only whole "
                          "tensors are read")
    code = f.pop("dtype")
    return BundleEntry(DTYPE_NAMES.get(code, f"dtype{code}"), dtype_code=code, **f)


def _header(buf) -> int:
    num_shards = 1
    for field, _, value in proto_fields(buf):
        if field == 1:
            num_shards = value
        elif field == 2 and value != 0:
            raise IOError("a big-endian tensor bundle; only little-endian ones are read")
    return num_shards


def _ckpt_sort_key(fp: str):
    """Numeric-suffix order for ``*.index`` files, so 'ckpt-12' is newer
    than 'ckpt-9' (a lexicographic sort would pick the older one)."""
    m = re.search(r"(\d+)\.index$", fp)
    return (int(m.group(1)) if m else -1, fp)


def _state_file_prefix(folder: str) -> Optional[str]:
    """``model_checkpoint_path`` of the text ``checkpoint`` file that
    ``tf.train.CheckpointManager``/``Checkpoint.save`` keep, if it names a
    checkpoint that exists."""
    state = os.path.join(folder, "checkpoint")
    if not os.path.isfile(state):
        return None
    with open(state, encoding="utf-8") as f:
        m = re.search(r'^model_checkpoint_path:\s*"((?:[^"\\]|\\.)*)"', f.read(), re.M)
    if not m:
        return None
    path = m.group(1).encode("latin-1").decode("unicode_escape")
    if not os.path.isabs(path):
        path = os.path.join(folder, path)
    return path if os.path.exists(path + ".index") else None


def resolve_prefix(path: str) -> str:
    """A checkpoint prefix from a prefix or a directory: the directory's
    ``checkpoint`` state file when it names one (``tf.train.
    latest_checkpoint``), else its numerically newest ``*.index`` (the
    reference writes with ``.write()``, which keeps no state file)."""
    if not os.path.isdir(path):
        return path
    prefix = _state_file_prefix(path)
    if prefix is not None:
        return prefix
    indexes = sorted(glob.glob(os.path.join(path, "*.index")), key=_ckpt_sort_key)
    if not indexes:
        raise IOError(f"no TF checkpoint found under {path}")
    return indexes[-1][:-len(".index")]


class BundleReader:
    """Reads a TF V2 checkpoint (``tf.train.load_checkpoint``'s reader)
    given its prefix or its directory."""

    def __init__(self, path: str):
        self.prefix = resolve_prefix(path)
        index = self.prefix + ".index"
        if not os.path.exists(index):
            raise IOError(f"no TF checkpoint at {path} ({index} does not exist)")
        table = read_table(index)
        if HEADER_KEY not in table:
            raise IOError(f"{index} has no bundle header: not a TF checkpoint")
        self.num_shards = _header(table.pop(HEADER_KEY))
        self.entries: Dict[str, BundleEntry] = {
            k.decode("utf-8"): parse_entry(k.decode("utf-8"), v) for k, v in table.items()}

    def shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"

    def get_tensor(self, name: str) -> np.ndarray:
        """The tensor ``name`` as a writable numpy array, its CRC checked."""
        e = self.entries.get(name)
        if e is None:
            raise KeyError(f"{name!r} is not in the checkpoint {self.prefix}")
        if e.dtype_code not in _READABLE:
            raise IOError(f"{name!r} holds a {e.dtype} tensor; only "
                          f"{sorted(DTYPE_NAMES[c] for c in _READABLE)} are read")
        dtype = np.dtype(_READABLE[e.dtype_code])
        count = int(np.prod(e.shape, dtype=np.int64))
        if e.size != count * dtype.itemsize:
            raise IOError(f"{name!r}: {e.size} bytes for shape {e.shape} {e.dtype}")
        buf = bytearray(e.size)
        with open(self.shard_path(e.shard_id), "rb") as f:
            f.seek(e.offset)
            if f.readinto(buf) != e.size:
                raise IOError(f"{name!r}: data shard {e.shard_id} ends before its bytes")
        if e.crc32c is not None and unmask_crc(e.crc32c) != crc32c(buf):
            raise IOError(f"{name!r}: CRC32C mismatch in {self.shard_path(e.shard_id)}")
        return np.frombuffer(buf, dtype).reshape(e.shape)


# --- writer ---------------------------------------------------------------

def _block(entries: List[Tuple[bytes, bytes]]) -> bytes:
    """A table block at restart interval 1 (no shared key prefixes)."""
    body, restarts = bytearray(), []
    for key, value in entries:
        restarts.append(len(body))
        body += encode_varint(0) + encode_varint(len(key)) + encode_varint(len(value))
        body += key + value
    if not restarts:
        restarts = [0]  # an empty block still has one restart point
    body += struct.pack(f"<{len(restarts)}I", *restarts) + struct.pack("<I", len(restarts))
    return bytes(body)


def _with_trailer(block: bytes) -> bytes:
    return block + b"\x00" + struct.pack("<I", mask_crc(crc32c(block + b"\x00")))


def _entry_proto(e: BundleEntry) -> bytes:
    shape = b"".join(proto_bytes(2, (proto_key(1, 0) + encode_varint(d)) if d else b"")
                     for d in e.shape)
    out = proto_key(1, 0) + encode_varint(e.dtype_code) + proto_bytes(2, shape)
    if e.offset:
        out += proto_key(4, 0) + encode_varint(e.offset)
    if e.size:
        out += proto_key(5, 0) + encode_varint(e.size)
    return out + proto_key(6, 5) + struct.pack("<I", e.crc32c)


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> str:
    """Write numeric ``tensors`` as a one-shard TF V2 checkpoint at
    ``prefix`` (``<prefix>.index`` and ``<prefix>.data-00000-of-00001``),
    in key order, and return the prefix. No object graph is written:
    ``tf.train.load_checkpoint`` reads the result, a
    ``tf.train.Checkpoint.restore`` does not."""
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    entries: List[Tuple[bytes, bytes]] = []
    offset = 0
    with open(f"{prefix}.data-00000-of-00001", "wb") as f:
        for name in sorted(tensors, key=lambda k: k.encode("utf-8")):
            arr = np.asarray(tensors[name])
            if arr.dtype.name not in _DT_CODES:
                raise ValueError(f"{name!r}: dtype {arr.dtype} is not written "
                                 f"(only {sorted(_DT_CODES)})")
            data = np.ascontiguousarray(arr, arr.dtype.newbyteorder("<"))
            f.write(memoryview(data.reshape(-1).view(np.uint8)))
            e = BundleEntry(arr.dtype.name, tuple(arr.shape), 0, offset, data.nbytes,
                            mask_crc(crc32c(data)), _DT_CODES[arr.dtype.name])
            entries.append((name.encode("utf-8"), _entry_proto(e)))
            offset += data.nbytes
    # BundleHeaderProto{num_shards: 1, version: {producer: 1}}, little-endian
    header = proto_key(1, 0) + encode_varint(1) + proto_bytes(3, proto_key(1, 0) + b"\x01")
    data_block = _with_trailer(_block([(HEADER_KEY, header)] + entries))
    meta_block = _with_trailer(_block([]))
    last_key = entries[-1][0] if entries else HEADER_KEY
    data_handle = encode_varint(0) + encode_varint(len(data_block) - BLOCK_TRAILER_SIZE)
    index_block = _with_trailer(_block([(last_key, data_handle)]))
    meta_at = len(data_block)
    index_at = meta_at + len(meta_block)
    handles = (encode_varint(meta_at) + encode_varint(len(meta_block) - BLOCK_TRAILER_SIZE)
               + encode_varint(index_at) + encode_varint(len(index_block) - BLOCK_TRAILER_SIZE))
    footer = handles.ljust(FOOTER_SIZE - 8, b"\x00") + struct.pack("<Q", TABLE_MAGIC)
    with open(f"{prefix}.index", "wb") as f:
        f.write(data_block + meta_block + index_block + footer)
    return prefix
