"""The port's LMDB codec (tpuseg_torch/data/lmdb_compat.py), its
auto-detecting RecordReader and cli/convert_db.py against the JAX
package's, on the CPU: databases written by either package's LmdbWriter
read record for record in the other's LmdbReader (overflow pages and a
multi-level B+tree included), and ImageReader yields the same batches from
an LMDB copy as from the tsrstore original."""

import os

import numpy as np
import pytest

from tpuseg.data.lmdb_compat import LmdbReader as JaxLmdbReader
from tpuseg.data.lmdb_compat import LmdbWriter as JaxLmdbWriter
from tpuseg_torch.cli import convert_db
from tpuseg_torch.data import build_db as tb
from tpuseg_torch.data.lmdb_compat import LmdbReader, LmdbWriter, is_lmdb_database
from tpuseg_torch.data.reader import ImageReader
from tpuseg_torch.data.recordstore import LmdbRecordReader, RecordReader, RecordWriter

from test_lmdb_compat import _handmade_lmdb
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _items(n=700, seed=1):
    """Small inline values, values past a page (overflow chains), and enough
    keys for branch pages above the leaves."""
    rng = np.random.default_rng(seed)
    items = {}
    for i in range(n):
        n_bytes = int(rng.integers(1, 500)) if i % 5 else int(rng.integers(4000, 90000))
        items[f"tile_{i:05d}:0,1".encode()] = rng.integers(0, 255, n_bytes,
                                                           dtype=np.uint8).tobytes()
    return items


@pytest.mark.parametrize("writer, reader", [(JaxLmdbWriter, LmdbReader),
                                            (LmdbWriter, JaxLmdbReader)],
                         ids=["tpuseg_writes", "port_writes"])
def test_lmdb_interop(tmp_path, writer, reader):
    items = _items()
    db = str(tmp_path / "x.lmdb")
    with writer(db) as w:
        for k in reversed(list(items)):  # unsorted puts; the writer sorts
            w.put(k, items[k])
    assert is_lmdb_database(db)
    with reader(db) as r:
        assert r.keys() == sorted(items) and len(r) == len(items)
        for i, k in enumerate(r.keys()):
            assert r.get_at(i) == items[k] and r.get(k) == items[k]


def test_writers_write_the_same_bytes(tmp_path):
    """Both writers are deterministic, so one record set gives byte-equal
    data.mdb files."""
    items = _items(300, 2)
    for name, cls in (("jax", JaxLmdbWriter), ("port", LmdbWriter)):
        with cls(str(tmp_path / name)) as w:
            for k, v in items.items():
                w.put(k, v)
    with open(tmp_path / "jax" / "data.mdb", "rb") as a, \
            open(tmp_path / "port" / "data.mdb", "rb") as b:
        assert a.read() == b.read()


def test_reader_parses_handmade_spec_bytes(tmp_path):
    records = {b"alpha:0": b"small-value", b"beta:0,1": b"x" * 200, b"gamma:1": b"y"}
    with LmdbReader(_handmade_lmdb(tmp_path, records)) as r:
        assert r.keys() == sorted(records)
        assert [r.get(k) for k in sorted(records)] == [records[k] for k in sorted(records)]


def test_record_reader_detects_lmdb(tmp_path):
    items = _items(40, 3)
    db = str(tmp_path / "ref.lmdb")
    with JaxLmdbWriter(db) as w:
        for k, v in items.items():
            w.put(k, v)
    r = RecordReader(db)
    try:
        assert isinstance(r, LmdbRecordReader)
        assert r.keys() == sorted(items) and len(r) == 40
        assert list(r) == [items[k] for k in sorted(items)]
        assert r.get(sorted(items)[3].decode()) == r.get_at(3)
    finally:
        r.close()
    tsr = str(tmp_path / "own.lmdb")
    with RecordWriter(tsr) as w:
        w.put(b"a:0", b"x")
    with RecordReader(tsr) as r:
        assert type(r) is RecordReader and r.keys() == [b"a:0"]
    with pytest.raises(IOError, match="Missing Database"):
        RecordReader(str(tmp_path / "nothing.lmdb"))


def _tsr_db(path, n=9, seed=5):
    rng = np.random.default_rng(seed)
    with RecordWriter(path) as w:
        for i in range(n):
            img = rng.integers(0, 4096, (16, 16, 1)).astype(np.uint16)
            msk = (rng.random((16, 16)) > 0.5).astype(np.uint8)
            w.put(f"tile{i:04d}:0,1", tb.serialize_image_mask_pair(img, msk))
    with open(os.path.join(path, "img_filenames.csv"), "w") as f:
        f.write("a.tif\nb.tif\n")
    return path


def _records(db):
    with RecordReader(db) as r:
        return [(k, r.get_at(i)) for i, k in enumerate(r.keys())]


def test_convert_round_trip(tmp_path):
    src = _tsr_db(str(tmp_path / "src.lmdb"))
    lmdb_db, back = str(tmp_path / "as_lmdb"), str(tmp_path / "back")
    assert convert_db.main(["--input_database", src, "--output_database", lmdb_db,
                            "--format", "lmdb"]) == 0
    assert convert_db.convert(lmdb_db, back, "tsr") == 9
    assert os.path.exists(os.path.join(lmdb_db, "data.mdb"))
    assert _records(lmdb_db) == _records(back) == _records(src)
    with JaxLmdbReader(lmdb_db) as r:
        assert list(zip(r.keys(), r)) == _records(src)
    with open(os.path.join(back, "img_filenames.csv")) as f:
        assert f.read() == "a.tif\nb.tif\n"
    with pytest.raises(IOError, match="not empty"):
        convert_db.convert(src, back, "tsr")


@pytest.mark.parametrize("fmt", ["tsr", "lmdb"])
@pytest.mark.parametrize("pre_existing", [False, True])
def test_convert_cleans_up_on_failure(tmp_path, monkeypatch, fmt, pre_existing):
    """A failure mid-copy aborts the writer and removes what the call
    created; an empty output directory the caller made stays, empty."""
    src = _tsr_db(str(tmp_path / "src.lmdb"))
    out = tmp_path / "out"
    if pre_existing:
        out.mkdir()
    real = RecordReader.get_at
    calls = []

    def flaky(self, i):
        calls.append(i)
        if len(calls) == 5:
            raise OSError("disk died")
        return real(self, i)

    monkeypatch.setattr(RecordReader, "get_at", flaky)
    with pytest.raises(OSError, match="disk died"):
        convert_db.convert(src, str(out), fmt)
    assert out.exists() == pre_existing
    if pre_existing:
        assert os.listdir(out) == []


def test_image_reader_same_batches_from_lmdb(tmp_path):
    src = _tsr_db(str(tmp_path / "train.lmdb"))
    lmdb_db = str(tmp_path / "train_ref.lmdb")
    convert_db.convert(src, lmdb_db, "lmdb")
    kw = dict(use_augmentation=False, shuffle=True, num_workers=1, raw_mode=True,
              layout="nhwc", seed=11)
    out = []
    for db in (src, lmdb_db):
        with ImageReader(db, **kw) as r:
            batches = r.batches(3)
            out.append([next(batches) for _ in range(4)])
            batches.close()
    for (gi, gm), (wi, wm) in zip(*out):
        assert gi.dtype == np.uint16 and gm.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
