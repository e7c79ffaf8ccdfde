"""Pure-Python LMDB codec for reference-dataset interop.

The port's own copy of ``tpuseg/data/lmdb_compat.py`` (the port imports
nothing of ``tpuseg``); keep the two in step. A database written by either
package's :class:`LmdbWriter` reads in the other's :class:`LmdbReader`.

The reference's durable training artifact is an LMDB database
(imagereader.py:120 ``lmdb.open(...)``, build_lmdb.py:136): a memory-mapped
copy-on-write B+tree of ``ImageMaskPair`` records keyed by ascii tile
names. The port's own store is tsrstore (recordstore.py), but an existing
reference deployment must be able to bring its data. The ``lmdb`` C
binding is not a dependency, so this module speaks the LMDB **on-disk
format** directly:

- :class:`LmdbReader` — read-only parser of the standard 64-bit
  little-endian LMDB layout (the reference's Linux/x86-64 deployment):
  dual meta pages with txnid arbitration, B+tree branch/leaf walk,
  ``F_BIGDATA`` overflow chains (every 256^2 uint16 record is ~131 KB, far
  above the ~2 KB inline-node limit, so overflow pages are the *common*
  case for this workload).
- :class:`LmdbWriter` — a minimal single-transaction writer producing a
  valid database (sorted keys, bottom-up B+tree build, both meta pages),
  so datasets can migrate *back* to reference deployments. Memory is
  bounded: record bytes spill to a temp sidecar as they arrive and pages
  stream to the output file, so converting a larger-than-RAM dataset
  works (RAM holds only the key -> locator map).

Scope: the main (unnamed) DB only — exactly what the reference uses (no
named sub-databases, no dupsort). Format constants follow LMDB 0.9
(mdb.c / lmdb.h; MDB_DATA_VERSION = 1).

``RecordReader`` (recordstore.py) auto-detects ``data.mdb`` and routes
through :class:`~tpuseg_torch.data.recordstore.LmdbRecordReader`, so every
consumer — ImageReader, training — reads reference-built databases
unconverted.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

# page flags (lmdb.h)
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

P_INVALID = 0xFFFFFFFFFFFFFFFF  # pgno_t(-1)
PAGEHDRSZ = 16
DEFAULT_PSIZE = 4096

# struct MDB_page header: mp_pgno u64, mp_pad u16, mp_flags u16,
# mp_lower u16, mp_upper u16 (the last two overlay pb_pages u32 for
# overflow pages)
_PAGEHDR = struct.Struct("<QHHHH")
# struct MDB_node header: mn_lo u16, mn_hi u16, mn_flags u16, mn_ksize u16
_NODEHDR = struct.Struct("<HHHH")
NODESIZE = _NODEHDR.size  # 8
# struct MDB_db: md_pad u32, md_flags u16, md_depth u16, md_branch_pages
# u64, md_leaf_pages u64, md_overflow_pages u64, md_entries u64, md_root u64
_MDB_DB = struct.Struct("<IHHQQQQQ")
# struct MDB_meta: mm_magic u32, mm_version u32, mm_address u64,
# mm_mapsize u64, mm_dbs[2], mm_last_pg u64, mm_txnid u64
_META_HEAD = struct.Struct("<IIQQ")
_META_TAIL = struct.Struct("<QQ")

DATA_MDB = "data.mdb"


def lmdb_data_path(path: str) -> Optional[str]:
    """The data file for an LMDB database at ``path`` (directory layout or
    MDB_NOSUBDIR single-file layout); None if neither exists."""
    if os.path.isdir(path):
        p = os.path.join(path, DATA_MDB)
        return p if os.path.exists(p) else None
    if os.path.isfile(path):
        return path
    return None


def is_lmdb_database(path: str) -> bool:
    """True if ``path`` holds an LMDB database (meta-page magic check)."""
    p = lmdb_data_path(path)
    if p is None:
        return False
    try:
        with open(p, "rb") as f:
            head = f.read(PAGEHDRSZ + 4)
        if len(head) < PAGEHDRSZ + 4:
            return False
        (magic,) = struct.unpack_from("<I", head, PAGEHDRSZ)
        return magic == MDB_MAGIC
    except OSError:
        return False


class _Meta:
    __slots__ = ("txnid", "mapsize", "psize", "main_root", "main_entries",
                 "main_depth", "last_pg", "version")


def _parse_meta(mm, pgno: int, psize_guess: int) -> Optional[_Meta]:
    base = pgno * psize_guess + PAGEHDRSZ
    if base + _META_HEAD.size + 2 * _MDB_DB.size + _META_TAIL.size > len(mm):
        return None
    magic, version, _addr, mapsize = _META_HEAD.unpack_from(mm, base)
    if magic != MDB_MAGIC:
        return None
    off = base + _META_HEAD.size
    free_db = _MDB_DB.unpack_from(mm, off)
    main_db = _MDB_DB.unpack_from(mm, off + _MDB_DB.size)
    last_pg, txnid = _META_TAIL.unpack_from(mm, off + 2 * _MDB_DB.size)
    m = _Meta()
    m.version = version
    m.txnid = txnid
    m.mapsize = mapsize
    # mm_psize lives in mm_dbs[FREE_DBI].md_pad (lmdb.h `#define mm_psize`)
    m.psize = free_db[0]
    m.main_root = main_db[7]
    m.main_entries = main_db[6]
    m.main_depth = main_db[2]
    m.last_pg = last_pg
    return m


class LmdbReader:
    """Read-only cursor over an LMDB database's main DB.

    Builds an in-memory key index on open (keys + value locators; values
    stay in the mmap until fetched — the page-cache-shared access pattern
    of the reference's per-worker read transactions, imagereader.py:180).
    """

    def __init__(self, path: str):
        data = lmdb_data_path(path)
        if data is None:
            raise IOError(f"Missing Database: {path}")
        f = open(data, "rb")
        try:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        finally:
            f.close()
        self._path = data
        try:
            self._open_meta()
            self._index: List[Tuple[bytes, int, int]] = []  # key, off, len
            self._by_key: Dict[bytes, int] = {}
            if self._root != P_INVALID:
                self._walk(self._root, 0)
            if len(self._index) != self._entries:
                raise IOError(
                    f"lmdb: walked {len(self._index)} records but meta "
                    f"promises {self._entries} in {data}")
            for i, (k, _, _) in enumerate(self._index):
                self._by_key[k] = i
        except struct.error as e:
            # normalize parse-time struct errors to the module's corruption
            # contract (every other corrupt-input path raises IOError)
            self._mm.close()
            raise IOError(f"lmdb: corrupt database structure in {data}: {e}")
        except Exception:
            self._mm.close()
            raise

    # -- format parsing --

    def _open_meta(self) -> None:
        mm = self._mm
        if len(mm) < 2 * PAGEHDRSZ:
            raise IOError(f"lmdb: file too small: {self._path}")
        # psize is self-describing: meta 0 always sits at byte 0, so this
        # probe is psize-independent; the true psize read from it then
        # locates meta page 1
        m0 = _parse_meta(mm, 0, DEFAULT_PSIZE)
        if m0 is None:
            (swapped,) = struct.unpack_from(">I", mm, PAGEHDRSZ)
            if swapped == MDB_MAGIC:
                raise IOError(
                    f"lmdb: big-endian database unsupported (this parser "
                    f"speaks the reference's x86-64 little-endian layout): "
                    f"{self._path}")
            raise IOError(f"lmdb: bad meta magic — not an LMDB database: {self._path}")
        psize = m0.psize
        if psize < 512 or psize & (psize - 1):
            raise IOError(f"lmdb: invalid page size {psize} in {self._path}")
        metas = [_parse_meta(mm, 0, psize), _parse_meta(mm, 1, psize)]
        metas = [m for m in metas if m is not None and m.psize == psize]
        if not metas:
            raise IOError(f"lmdb: no valid meta page in {self._path}")
        meta = max(metas, key=lambda m: m.txnid)
        if meta.version != MDB_DATA_VERSION:
            raise IOError(
                f"lmdb: unsupported format version {meta.version} "
                f"(expected {MDB_DATA_VERSION}) in {self._path}")
        self._psize = psize
        self._root = meta.main_root
        self._entries = meta.main_entries
        self._depth_limit = max(meta.main_depth, 1) + 1

    def _page(self, pgno: int, full: bool = False) -> int:
        """Byte offset of page ``pgno``; ``full=True`` requires the whole
        page inside the file (branch/leaf pages — a truncated file must
        raise IOError here, not struct.error/short-slice downstream)."""
        off = pgno * self._psize
        need = self._psize if full else PAGEHDRSZ
        if pgno == P_INVALID or off + need > len(self._mm):
            raise IOError(f"lmdb: page {pgno} out of bounds in {self._path}")
        return off

    def _walk(self, pgno: int, depth: int) -> None:
        if depth > self._depth_limit:
            raise IOError(f"lmdb: B+tree deeper than meta depth in {self._path}")
        mm = self._mm
        off = self._page(pgno, full=True)
        _pg, _pad, flags, lower, upper = _PAGEHDR.unpack_from(mm, off)
        if flags & P_LEAF2:
            raise IOError(f"lmdb: LEAF2 (fixed-size key) pages unsupported in {self._path}")
        if not flags & (P_BRANCH | P_LEAF):
            raise IOError(f"lmdb: page {pgno} is not branch/leaf (flags {flags:#x})")
        if lower < PAGEHDRSZ or lower > upper or upper > self._psize:
            raise IOError(f"lmdb: corrupt page bounds on page {pgno} in {self._path}")
        nkeys = (lower - PAGEHDRSZ) >> 1
        for i in range(nkeys):
            (ptr,) = struct.unpack_from("<H", mm, off + PAGEHDRSZ + 2 * i)
            node = off + ptr
            if node + NODESIZE > off + self._psize:
                raise IOError(f"lmdb: node offset out of page {pgno} in {self._path}")
            lo, hi, nflags, ksize = _NODEHDR.unpack_from(mm, node)
            koff = node + NODESIZE
            if flags & P_BRANCH:
                child = lo | (hi << 16) | (nflags << 32)
                self._walk(child, depth + 1)
                continue
            # bound the key (and any trailing overflow pgno) to THIS page: a
            # corrupt ksize would otherwise silently read the neighboring
            # page's bytes instead of raising
            if koff + ksize + 8 * bool(nflags & F_BIGDATA) > off + self._psize:
                raise IOError(f"lmdb: key runs off page {pgno} in {self._path}")
            key = bytes(mm[koff:koff + ksize])
            dsize = lo | (hi << 16)
            if nflags & (F_SUBDATA | F_DUPDATA):
                raise IOError(f"lmdb: dupsort/sub-DB data unsupported in {self._path}")
            if nflags & F_BIGDATA:
                (ovpg,) = struct.unpack_from("<Q", mm, koff + ksize)
                ovoff = self._page(ovpg)
                _o_pg, _o_pad, o_flags, o_lo, o_hi = _PAGEHDR.unpack_from(mm, ovoff)
                if not o_flags & P_OVERFLOW:
                    raise IOError(f"lmdb: bigdata pgno {ovpg} is not an overflow page")
                npages = o_lo | (o_hi << 16)  # pb_pages overlays lower/upper
                if dsize + PAGEHDRSZ > npages * self._psize or \
                        ovoff + PAGEHDRSZ + dsize > len(mm):
                    raise IOError(f"lmdb: overflow chain too short for record on page {ovpg}")
                self._index.append((key, ovoff + PAGEHDRSZ, dsize))
            else:
                doff = koff + ksize
                if doff + dsize > off + self._psize:
                    raise IOError(f"lmdb: inline data runs off page {pgno} in {self._path}")
                self._index.append((key, doff, dsize))

    # -- read API (RecordReader-shaped) --

    def __len__(self) -> int:
        return len(self._index)

    def keys(self) -> List[bytes]:
        return [k for k, _, _ in self._index]

    def get_at(self, i: int) -> bytes:
        _, off, length = self._index[i]
        return bytes(self._mm[off:off + length])

    def get(self, key) -> bytes:
        if isinstance(key, str):
            key = key.encode("ascii")
        i = self._by_key.get(key)
        if i is None:
            raise KeyError(key)
        return self.get_at(i)

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        for i, (k, _, _) in enumerate(self._index):
            yield k, self.get_at(i)

    def __iter__(self) -> Iterator[bytes]:
        for i in range(len(self._index)):
            yield self.get_at(i)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LmdbWriter:
    """Single-transaction LMDB database writer (directory layout).

    Collects puts in memory, then :meth:`close` sorts by key (LMDB's
    default memcmp order == Python bytes ordering) and emits the complete
    file: meta pages 0/1, leaf pages with inline or F_BIGDATA overflow
    values, and a bottom-up branch hierarchy. The result round-trips
    through :class:`LmdbReader` and through the reference's ``lmdb``
    binding (same layout liblmdb writes for a fresh single-txn load).
    """

    # value size above which data moves to overflow pages; liblmdb uses
    # nodemax = (psize - PAGEHDRSZ)/2 rounded even minus node overhead —
    # anything we choose <= that is a layout liblmdb itself could produce
    def __init__(self, path: str, psize: int = DEFAULT_PSIZE, mapsize: Optional[int] = None):
        if psize < 512 or psize & (psize - 1):
            raise ValueError(f"psize must be a power of two >= 512, got {psize}")
        os.makedirs(path, exist_ok=True)
        self._path = os.path.join(path, DATA_MDB)
        self._psize = psize
        self._mapsize = mapsize
        self._closed = False
        self._committed = False
        # inline limit: key+data node must fit a half page like liblmdb
        self._nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
        # bounded memory: values spill to a temp sidecar as they arrive
        # (puts come in any order but pages must be key-sorted, so values
        # can't stream into final pages directly); RAM holds only
        # key -> (offset, length). A 100k-record image dataset would
        # otherwise buffer ~10+ GB.
        self._spill_path = self._path + ".spill"
        self._spill = open(self._spill_path, "w+b")
        self._items: Dict[bytes, Tuple[int, int]] = {}
        self._spill_pos = 0

    def put(self, key, value: bytes) -> None:
        if self._closed:
            raise IOError("lmdb: writer already closed")
        if isinstance(key, str):
            key = key.encode("ascii")
        if not key or len(key) > 511:  # MDB_MAXKEYSIZE default
            raise ValueError(f"lmdb: key length {len(key)} outside 1..511")
        # a key whose leaf node cannot fit even an empty page would only
        # blow up at close() deep in the page packer; liblmdb
        # enforces the same limit per page size at put time
        node = NODESIZE + len(key) + 8  # worst case: F_BIGDATA pgno payload
        if node > self._psize - PAGEHDRSZ - 2:
            raise ValueError(
                f"lmdb: key length {len(key)} too large for page size "
                f"{self._psize}")
        if len(value) > 0xFFFFFFFF:
            # the node header stores dsize in 32 bits; liblmdb rejects
            # bigger values too — silently masking corrupted the database
            raise ValueError(f"lmdb: value length {len(value)} exceeds 4 GiB")
        value = bytes(value)
        # duplicate keys: last write wins, like mdb_put (the old spill bytes
        # become dead space in the temp file)
        self._spill.write(value)
        self._items[key] = (self._spill_pos, len(value))
        self._spill_pos += len(value)

    def _value(self, loc: Tuple[int, int]) -> bytes:
        off, length = loc
        self._spill.seek(off)
        return self._spill.read(length)

    def putmany(self, items: Iterable[Tuple[bytes, bytes]]) -> None:
        for k, v in items:
            self.put(k, v)

    def close(self) -> None:
        if self._closed:
            if not self._committed:
                raise IOError(
                    "lmdb: writer was aborted or a previous close() failed; "
                    f"{self._path} was not written")
            return
        self._closed = True
        tmp = self._path + ".tmp"
        out = open(tmp, "wb")
        try:
            self._emit(out)
            out.close()
            os.replace(tmp, self._path)
            self._committed = True
        finally:
            # a failure mid-emission (e.g. ENOSPC) must not leak the tmp fd
            # or leave data.mdb.tmp/.spill behind — and a retried close()
            # raises above instead of silently "succeeding" with no database
            if not self._committed:
                try:
                    out.close()
                except OSError:
                    pass
                try:
                    os.remove(tmp)
                except OSError:
                    pass
            self._spill.close()
            try:
                os.remove(self._spill_path)
            except OSError:
                pass
        # an empty lock file, as liblmdb leaves behind
        lock = os.path.join(os.path.dirname(self._path), "lock.mdb")
        if not os.path.exists(lock):
            open(lock, "wb").close()

    def abort(self) -> None:
        """Release resources without writing the database (the directory may
        hold a stale ``.spill``-free partial state; callers delete it)."""
        if self._closed:
            return
        self._closed = True
        self._spill.close()
        try:
            os.remove(self._spill_path)
        except OSError:
            pass

    def _emit(self, out) -> None:
        """Stream the complete database image (meta + leaf/branch/overflow
        pages) into the open ``out`` file."""
        psize = self._psize
        counts = {"branch": 0, "leaf": 0, "overflow": 0}
        out.write(b"\0" * (2 * psize))  # meta page 0/1 placeholders
        next_pgno = [2]  # pages stream to the file in pgno order

        def add_page(raw: bytes) -> int:
            assert len(raw) == psize
            pgno = next_pgno[0]
            next_pgno[0] += 1
            out.write(raw)
            return pgno

        def page_hdr(pgno: int, flags: int, lower: int, upper: int) -> bytes:
            return _PAGEHDR.pack(pgno, 0, flags, lower, upper)

        items = sorted(self._items.items())

        # -- leaf level (and overflow chains) --
        leaf_entries: List[Tuple[bytes, Tuple[int, int], int]] = []  # key, loc, flags
        for key, loc in items:
            inline_sz = NODESIZE + len(key) + loc[1]
            if inline_sz <= self._nodemax:
                leaf_entries.append((key, loc, 0))
            else:
                leaf_entries.append((key, loc, F_BIGDATA))

        level: List[Tuple[bytes, int]] = []  # (first key of page, pgno)

        def flush_leaf(nodes: List[Tuple[bytes, Tuple[int, int], int]]) -> None:
            # pass 1: emit overflow chains (fixing their pgnos) and build
            # each node's payload; pass 2: pack the leaf page itself
            packed: List[Tuple[bytes, bytes, int, int]] = []  # key, payload, dsize, flags
            for key, loc, nflags in nodes:
                value = self._value(loc)
                dsize = len(value)
                if nflags & F_BIGDATA:
                    npages = (PAGEHDRSZ + dsize + psize - 1) // psize
                    first = next_pgno[0]
                    # stream header, value, padding straight to the file —
                    # assembling the chain as one blob then re-slicing it
                    # copied every big value ~4x
                    out.write(page_hdr(first, P_OVERFLOW,
                                       npages & 0xFFFF, (npages >> 16) & 0xFFFF))
                    out.write(value)
                    out.write(b"\0" * (npages * psize - PAGEHDRSZ - dsize))
                    next_pgno[0] += npages
                    counts["overflow"] += npages
                    packed.append((key, struct.pack("<Q", first), dsize, nflags))
                else:
                    packed.append((key, value, dsize, nflags))
            # nodes grow down from page end; ptr array grows up from header
            body = bytearray(psize)
            upper = psize
            ptrs: List[int] = []
            for key, payload, dsize, nflags in packed:
                nsz = NODESIZE + len(key) + len(payload)
                nsz += nsz & 1  # even alignment (mdb_leaf_size EVEN())
                upper -= nsz
                node = _NODEHDR.pack(dsize & 0xFFFF, (dsize >> 16) & 0xFFFF,
                                     nflags, len(key)) + key + payload
                body[upper:upper + len(node)] = node
                ptrs.append(upper)
            lower = PAGEHDRSZ + 2 * len(ptrs)
            body[:PAGEHDRSZ] = page_hdr(next_pgno[0], P_LEAF, lower, upper)
            struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
            pgno = add_page(bytes(body))
            counts["leaf"] += 1
            level.append((nodes[0][0] if nodes else b"", pgno))

        cur: List[Tuple[bytes, Tuple[int, int], int]] = []
        used = 0
        for key, loc, nflags in leaf_entries:
            payload_len = 8 if nflags & F_BIGDATA else loc[1]
            nsz = NODESIZE + len(key) + payload_len
            nsz += nsz & 1
            need = 2 + nsz  # ptr slot + node
            if cur and PAGEHDRSZ + used + need > psize:
                flush_leaf(cur)
                cur, used = [], 0
            cur.append((key, loc, nflags))
            used += need
        if cur:
            flush_leaf(cur)

        depth = 1 if level else 0

        # -- branch levels, bottom-up --
        while len(level) > 1:
            next_level: List[Tuple[bytes, int]] = []

            def flush_branch(children: List[Tuple[bytes, int]]) -> None:
                body = bytearray(psize)
                upper = psize
                ptrs = []
                for i, (key, child) in enumerate(children):
                    k = b"" if i == 0 else key  # node 0 carries no key
                    nsz = NODESIZE + len(k)
                    nsz += nsz & 1
                    upper -= nsz
                    node = _NODEHDR.pack(child & 0xFFFF, (child >> 16) & 0xFFFF,
                                         (child >> 32) & 0xFFFF, len(k)) + k
                    body[upper:upper + len(node)] = node
                    ptrs.append(upper)
                lower = PAGEHDRSZ + 2 * len(ptrs)
                body[:PAGEHDRSZ] = page_hdr(next_pgno[0], P_BRANCH, lower, upper)
                struct.pack_into(f"<{len(ptrs)}H", body, PAGEHDRSZ, *ptrs)
                pgno = add_page(bytes(body))
                counts["branch"] += 1
                next_level.append((children[0][0], pgno))

            group: List[Tuple[bytes, int]] = []
            gused = 0
            for key, child in level:
                k = b"" if not group else key
                nsz = NODESIZE + len(k)
                nsz += nsz & 1
                need = 2 + nsz
                if group and PAGEHDRSZ + gused + need > psize:
                    flush_branch(group)
                    group, gused = [], 0
                    k = b""  # re-head: first node of the new page has no key
                    nsz = NODESIZE
                    need = 2 + nsz
                group.append((key, child))
                gused += need
            if group:
                flush_branch(group)
            level = next_level
            depth += 1

        root = level[0][1] if level else P_INVALID
        last_pg = next_pgno[0] - 1
        file_size = next_pgno[0] * psize
        mapsize = self._mapsize or max(file_size, 1 << 20)

        def meta_page(pgno: int) -> bytes:
            free_db = _MDB_DB.pack(psize, 0x08, 0, 0, 0, 0, 0, P_INVALID)  # MDB_INTEGERKEY
            main_db = _MDB_DB.pack(0, 0, depth, counts["branch"], counts["leaf"],
                                   counts["overflow"], len(items), root)
            meta = (_META_HEAD.pack(MDB_MAGIC, MDB_DATA_VERSION, 0, mapsize)
                    + free_db + main_db + _META_TAIL.pack(last_pg, 1))
            body = page_hdr(pgno, P_META, 0, 0) + meta
            return body + b"\0" * (psize - len(body))

        out.seek(0)
        out.write(meta_page(0))
        out.write(meta_page(1))

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # an exception inside the with-block must not commit a partial DB
        if exc_type is not None:
            self.abort()
        else:
            self.close()
