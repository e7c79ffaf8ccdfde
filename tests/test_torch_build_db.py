"""The port's database builder (tpuseg_torch/data/build_db.py,
cli/build_lmdb.py) against the JAX package's (tpuseg/data/build_db.py) on
synthetic folders, on the CPU: the same seeded train/test split, the same
keys and byte-equal records, for tiled-BigTIFF pairs streamed from disk,
pairs read whole (PNG) and untiled pairs."""

import os

import numpy as np
import pytest

from tpuseg.data import build_db as jb
from tpuseg.data.recordstore import RecordReader as JaxRecordReader
from tpuseg_torch.cli.build_lmdb import main as build_main
from tpuseg_torch.data import build_db as tb
from tpuseg_torch.data.recordstore import RecordReader, RecordWriter
from tpuseg_torch.utils import bigtiff
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def _folders(tmp_path, kind, n=5, seed=0):
    """``n`` image/mask pairs of assorted sizes: tiled BigTIFF ("tif") or
    PNG ("png"); uint16 images, uint8 masks of 3 classes."""
    import imageio.v3 as iio

    imgdir, mskdir = tmp_path / f"{kind}_img", tmp_path / f"{kind}_msk"
    imgdir.mkdir(), mskdir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = int(rng.integers(130, 260)), int(rng.integers(130, 260))
        img = rng.integers(0, 4096, (h, w)).astype(np.uint16)
        msk = (rng.random((h, w)) * 3).astype(np.uint8)
        if i == 0:
            msk[:] = 1  # one class present
        name = f"s{i}.{kind}"
        if kind == "tif":
            bigtiff.write_bigtiff(str(imgdir / name), img, tile=(64, 64))
            bigtiff.write_bigtiff(str(mskdir / name), msk, tile=(64, 64))
        else:
            iio.imwrite(str(imgdir / name), img)
            iio.imwrite(str(mskdir / name), msk)
    return str(imgdir), str(mskdir)


def _contents(reader_cls, db):
    r = reader_cls(db)
    try:
        return {k: r.get_at(i) for i, k in enumerate(r.keys())}
    finally:
        r.close()


@pytest.mark.parametrize("kind, use_tiling", [("tif", True), ("png", True), ("tif", False)])
def test_build_databases_matches_tpuseg(tmp_path, kind, use_tiling):
    imgdir, mskdir = _folders(tmp_path, kind)
    common = dict(train_fraction=0.6, image_format=kind, use_tiling=use_tiling,
                  tile_size=128, seed=7)
    want = jb.build_databases(imgdir, mskdir, str(tmp_path / "jax"), "d", **common)
    got = tb.build_databases(imgdir, mskdir, str(tmp_path / "port"), "d", **common)
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(os.path.join(g, "img_filenames.csv")) as f1, \
                open(os.path.join(w, "img_filenames.csv")) as f2:
            assert f1.read() == f2.read()  # the same split, in the same order
        port_recs, jax_recs = _contents(RecordReader, g), _contents(JaxRecordReader, w)
        assert list(port_recs) == list(jax_recs) and port_recs
        for k in jax_recs:
            assert port_recs[k] == jax_recs[k], k
    if use_tiling:
        keys = [k.decode() for k in _contents(RecordReader, got[0])]
        assert all("_i" in k and "_j" in k and ":" in k for k in keys)


def test_streamed_records_equal_in_ram_tiling(tmp_path):
    """A tiled-BigTIFF pair tiled from disk gives the keys and records of
    process_slide_tiling over the whole arrays (edge boxes slid to fit,
    duplicates dropped)."""
    rng = np.random.default_rng(6)
    img = rng.integers(0, 4096, (600, 500)).astype(np.uint16)
    msk = rng.integers(0, 3, (600, 500)).astype(np.uint8)
    ip, mp = str(tmp_path / "i.tif"), str(tmp_path / "m.tif")
    bigtiff.write_bigtiff(ip, img, tile=(128, 128))
    bigtiff.write_bigtiff(mp, msk, tile=(128, 128))
    db = str(tmp_path / "db")
    with RecordWriter(db) as w:
        tb._stream_slide_tiling(w, ip, mp, 256, "slide")
    tiles, mtiles, keys = tb.process_slide_tiling(img, msk, 256, "slide")
    assert keys == jb.process_slide_tiling(img, msk, 256, "slide")[2]
    stored = _contents(RecordReader, db)
    assert sorted(stored) == sorted(k.encode() for k in keys)
    for t, m, k in zip(tiles, mtiles, keys):
        assert stored[k.encode()] == tb.serialize_image_mask_pair(t, m)


@pytest.mark.parametrize("h, w, tile", [(300, 300, 128), (512, 512, 512), (900, 700, 512),
                                        (416, 416, 512), (2048, 1024, 512), (130, 257, 128)])
def test_tiling_boxes_match_tpuseg(h, w, tile):
    boxes = tb.tiling_boxes(h, w, tile)
    assert boxes == jb.tiling_boxes(h, w, tile)
    assert len(boxes) == len(set(boxes))


def test_enforce_size_multiple_matches_tpuseg():
    img = np.random.default_rng(0).random((37, 50))
    np.testing.assert_array_equal(tb.enforce_size_multiple(img), jb.enforce_size_multiple(img))


def test_midstream_failure_leaves_no_database(tmp_path, monkeypatch):
    """An I/O error after some tiles were streamed propagates (a fallback to
    the in-RAM path would write the streamed keys twice) and the database
    directory is removed, not finalized with part of its records."""
    imgdir, mskdir = _folders(tmp_path, "tif", n=2)

    def partial_then_fail(writer, img_path, msk_path, tile_size, block_key, emitted=None):
        writer.put(f"{block_key}_i0_j0:0,1", b"partial-record")
        emitted["records"] = emitted.get("records", 0) + 1
        raise IOError("disk went away mid-stream")

    monkeypatch.setattr(tb, "_stream_slide_tiling", partial_then_fail)
    with pytest.raises(IOError, match="mid-stream"):
        tb.generate_database(["s0.tif", "s1.tif"], "train-mid.lmdb", imgdir, mskdir,
                             str(tmp_path / "out"), tile_size=128)
    assert not os.path.exists(tmp_path / "out" / "train-mid.lmdb")


def test_foreign_bigtiff_falls_back_before_first_put(tmp_path, monkeypatch):
    """A pair the BigTIFF reader rejects before any put is built through
    imread instead, with the same records the streamed path writes."""
    imgdir, mskdir = _folders(tmp_path, "tif", n=2)
    streamed = tb.generate_database(["s0.tif", "s1.tif"], "a", imgdir, mskdir,
                                    str(tmp_path / "out"), tile_size=128)
    want = _contents(RecordReader, streamed)

    def reject(*a, **k):
        raise IOError("BigTIFF is not tiled (strip layout unsupported)")

    monkeypatch.setattr(tb, "_stream_slide_tiling", reject)
    fallback = tb.generate_database(["s0.tif", "s1.tif"], "b", imgdir, mskdir,
                                    str(tmp_path / "out"), tile_size=128)
    assert _contents(RecordReader, fallback) == want


def test_float_masks_and_bad_tile_size_refused(tmp_path):
    from tpuseg_torch.utils.imagio import imwrite

    imgdir, mskdir = tmp_path / "imgs", tmp_path / "msks"
    imgdir.mkdir(), mskdir.mkdir()
    imwrite(str(imgdir / "a.tif"), np.zeros((32, 32), np.uint16))
    imwrite(str(mskdir / "a.tif"), np.zeros((32, 32), np.float32))
    with pytest.raises(ValueError, match="integer type"):
        tb.generate_database(["a.tif"], "train-f.lmdb", str(imgdir), str(mskdir),
                             str(tmp_path), tile_size=0)
    assert not os.path.exists(tmp_path / "train-f.lmdb")
    with pytest.raises(ValueError, match="integer type"):  # streamed pair
        tb.generate_database(["a.tif"], "train-g.lmdb", str(imgdir), str(mskdir),
                             str(tmp_path), tile_size=16)
    with pytest.raises(ValueError, match="multiples of 16"):
        tb.build_databases(str(imgdir), str(mskdir), str(tmp_path), "x", use_tiling=True,
                           tile_size=100)


def test_build_lmdb_cli(tmp_path):
    imgdir, mskdir = _folders(tmp_path, "tif", n=4)
    out = str(tmp_path / "out")
    assert build_main(["--image_folder", imgdir, "--mask_folder", mskdir,
                       "--output_folder", out, "--dataset_name", "cli", "--use_tiling", "1",
                       "--tile_size", "128", "--seed", "3", "--train_fraction", "0.5"]) == 0
    train, test = (_contents(RecordReader, os.path.join(out, f"{s}-cli.lmdb"))
                   for s in ("train", "test"))
    names = {k.decode().split("_i")[0] for k in list(train) + list(test)}
    assert names == {f"s{i}" for i in range(4)}
    assert not {k.decode().split("_i")[0] for k in train} & \
        {k.decode().split("_i")[0] for k in test}
