"""The tsrstore record store, in pure Python over ``mmap``.

The port's own copy of ``tpuseg/data/recordstore.py``, on the same on-disk
format, so a database written by either package reads in the other. It
does not load the JAX package's native library (``native/``): reads are
zero-copy slices of the mapping, which is what the readers need.

A "database" is a directory (named ``*.lmdb`` for reference CLI parity)
holding ``data.tsr``:

    header  "TSRSTOR1" | u64 count | u64 index_offset
    records (u32 key_len | u64 val_len | key | value) ...
    index   (u32 key_len | u64 val_offset | u64 val_len | key) ... in key order

``RecordReader(db)`` also reads databases the reference built (LMDB,
``data.mdb``): it detects them and serves them through
:class:`LmdbRecordReader` over the pure-Python codec in ``lmdb_compat.py``.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional

_MAGIC = b"TSRSTOR1"
_HEADER = struct.Struct("<8sQQ")  # magic, count, index_offset
_REC = struct.Struct("<IQ")  # key_len, val_len
_IDX = struct.Struct("<IQQ")  # key_len, val_offset, val_len

DATA_FILENAME = "data.tsr"


def _data_path(db_dir: str) -> str:
    return os.path.join(db_dir, DATA_FILENAME)


class RecordWriter:
    """Append-only writer; call close() to write the sorted index."""

    def __init__(self, db_dir: str):
        os.makedirs(db_dir, exist_ok=True)
        self._path = _data_path(db_dir)
        self._index: List[tuple] = []
        self._file = open(self._path, "wb")
        self._file.write(_HEADER.pack(_MAGIC, 0, 0))
        self._pos = _HEADER.size

    def put(self, key: bytes, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode("ascii")
        self._file.write(_REC.pack(len(key), len(value)))
        self._file.write(key)
        self._file.write(value)
        val_offset = self._pos + _REC.size + len(key)
        self._index.append((key, val_offset, len(value)))
        self._pos = val_offset + len(value)

    def close(self) -> None:
        if self._file is None:
            return
        index_offset = self._pos
        # duplicate puts resolve to the latest value (LMDB overwrite
        # semantics, as the JAX package's writers do)
        dedup = {}
        for key, off, length in self._index:
            dedup[key] = (off, length)
        for key in sorted(dedup):
            off, length = dedup[key]
            self._file.write(_IDX.pack(len(key), off, length))
            self._file.write(key)
        self._file.seek(8)
        self._file.write(struct.pack("<QQ", len(dedup), index_offset))
        self._file.close()
        self._file = None

    def abort(self) -> None:
        """Release the file WITHOUT writing the index: the header keeps its
        zeroed count/index_offset, so opening the partial file raises."""
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # commit only on a clean exit: finalizing during an exception would
        # leave a valid-looking database with a truncated record set
        if exc_type is None:
            self.close()
        else:
            self.abort()


class RecordReader:
    """Read-only, memory-mapped view of a database directory; safe to open
    independently in each reader process (the pages are shared through the
    page cache).

    A directory holding ``data.mdb`` instead of ``data.tsr`` (or an
    ``MDB_NOSUBDIR`` single data file) is a reference-built LMDB database:
    ``RecordReader(db)`` then returns an :class:`LmdbRecordReader`, the
    same interface, so ImageReader and training read it unconverted."""

    def __new__(cls, db_dir: str):
        if cls is RecordReader and not os.path.exists(_data_path(db_dir)):
            from tpuseg_torch.data import lmdb_compat

            if lmdb_compat.lmdb_data_path(db_dir) is not None:
                return super().__new__(LmdbRecordReader)
        return super().__new__(cls)

    def __init__(self, db_dir: str):
        path = _data_path(db_dir)
        if not os.path.exists(path):
            raise IOError(f"Missing Database: {db_dir}")  # imagereader.py:110-113
        self._mm: Optional[mmap.mmap] = None
        with open(path, "rb") as f:
            try:
                self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except ValueError as e:  # 0-byte file: "cannot mmap an empty file"
                raise IOError(f"tsrstore: cannot map {path}: {e}")
        try:
            magic, count, index_offset = _HEADER.unpack_from(self._mm, 0)
        except struct.error as e:  # < 24-byte file (builder killed early)
            raise IOError(f"tsrstore: truncated header in {path}: {e}")
        if magic != _MAGIC:
            raise IOError(f"tsrstore: bad magic in {path}")
        size = len(self._mm)
        if (index_offset < _HEADER.size or index_offset > size
                or count > (size - index_offset) // _IDX.size):
            raise IOError(f"tsrstore: corrupt header in {path}")
        self._index = []
        self._by_key = {}
        pos = index_offset
        for i in range(count):
            if size - pos < _IDX.size:
                raise IOError(f"tsrstore: truncated index in {path}")
            kl, off, length = _IDX.unpack_from(self._mm, pos)
            pos += _IDX.size
            if size - pos < kl or off > size or size - off < length:
                raise IOError(f"tsrstore: corrupt index entry in {path}")
            key = bytes(self._mm[pos:pos + kl])
            pos += kl
            self._index.append((key, off, length))
            self._by_key[key] = i

    def __len__(self) -> int:
        return len(self._index)

    def _check_open(self) -> None:
        if self._mm is None:
            raise ValueError("tsrstore: reader is closed")

    def keys(self) -> List[bytes]:
        """All keys in sorted order (LMDB cursor iteration parity)."""
        self._check_open()
        return [k for k, _, _ in self._index]

    def get(self, key: bytes) -> bytes:
        self._check_open()
        if isinstance(key, str):
            key = key.encode("ascii")
        i = self._by_key.get(key)
        if i is None:
            raise KeyError(key)
        return self.get_at(i)

    def get_at(self, i: int) -> bytes:
        """Value at sorted position i (negative indices wrap)."""
        self._check_open()
        if i < 0:
            i += len(self._index)
        if not 0 <= i < len(self._index):
            raise IndexError(i)
        _, off, length = self._index[i]
        return bytes(self._mm[off:off + length])

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self)):
            yield self.get_at(i)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LmdbRecordReader(RecordReader):
    """RecordReader interface over a reference-built LMDB database; keys
    come back in LMDB's sorted cursor order, the contract tsrstore's sorted
    index gives (``tpuseg.data.recordstore.LmdbRecordReader``)."""

    def __init__(self, db_dir: str):
        from tpuseg_torch.data import lmdb_compat

        self._r = lmdb_compat.LmdbReader(db_dir)

    def __len__(self) -> int:
        return len(self._r)

    def keys(self) -> List[bytes]:
        return self._r.keys()

    def get(self, key) -> bytes:
        return self._r.get(key)

    def get_at(self, i: int) -> bytes:
        return self._r.get_at(i)

    def __iter__(self) -> Iterator[bytes]:
        return iter(self._r)

    def close(self) -> None:
        self._r.close()
