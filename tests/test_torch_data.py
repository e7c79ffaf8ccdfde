"""The port's data layer against tpuseg's on the CPU.

- record codec: the port's hand-written ImageMaskPair encoder writes the
  bytes protobuf writes (tpuseg.data.build_db), and each decodes the other;
- record store: a database written by either package's RecordWriter reads
  identically through the other's RecordReader;
- reader: tpuseg_torch.data.reader.ImageReader in raw mode yields the same
  arrays, in the same order, as tpuseg.data.reader.ImageReader under the
  same seed (one worker; shuffled, and the strided walk);
- preprocess and host augmentation: the port's copies give tpuseg's
  results.
"""

import numpy as np
import pytest

from tpuseg.aug.host import augment_image as jax_augment_image
from tpuseg.data import build_db as jbuild
from tpuseg.data import preprocess as jpre
from tpuseg.data.reader import ImageReader as JaxReader
from tpuseg.data.recordstore import RecordReader as JaxRecordReader
from tpuseg.data.recordstore import RecordWriter as JaxRecordWriter
from tpuseg_torch.aug.host import augment_image
from tpuseg_torch.data import build_db as tbuild
from tpuseg_torch.data import preprocess as tpre
from tpuseg_torch.data.reader import ImageReader
from tpuseg_torch.data.recordstore import RecordReader, RecordWriter
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

CASES = [
    (np.arange(16 * 16, dtype=np.uint16).reshape(16, 16), np.zeros((16, 16), np.uint8)),
    (np.random.default_rng(0).integers(0, 65535, (32, 48, 1)).astype(np.uint16),
     np.random.default_rng(1).integers(0, 3, (32, 48)).astype(np.uint8)),
    (np.random.default_rng(2).normal(0, 1, (16, 32, 3)).astype(np.float32),
     np.random.default_rng(3).integers(0, 200, (16, 32)).astype(np.int32)),
    (np.zeros((0, 0, 1), np.uint8), np.zeros((0, 0), np.uint8)),
]


@pytest.mark.parametrize("i", range(len(CASES)))
def test_codec_bytes_equal_protobuf(i):
    img, msk = CASES[i]
    want = jbuild.serialize_image_mask_pair(img, msk)
    got = tbuild.serialize_image_mask_pair(img, msk)
    assert got == want
    for decode, buf in ((tbuild.deserialize_image_mask_pair, want),
                        (jbuild.deserialize_image_mask_pair, got)):
        a, m = decode(buf)
        assert a.dtype == img.dtype and m.dtype == msk.dtype
        np.testing.assert_array_equal(a, img.reshape(a.shape))
        np.testing.assert_array_equal(m, msk)


def test_decoder_reads_any_field_order_and_skips_unknown_fields():
    img, msk = CASES[1]
    from tpuseg.data.isg_ai_pb2 import ImageMaskPair

    buf = jbuild.serialize_image_mask_pair(img, msk)
    # an unknown varint field 15 and a repeated field 1 (the last one wins)
    extra = bytes([15 << 3, 0x05]) + tbuild.encode_image_mask_pair({"channels": 1})
    fields = tbuild.decode_image_mask_pair(extra + buf + tbuild.encode_image_mask_pair(
        {"img_type": "<u2"}))
    assert fields["channels"] == 1 and fields["img_type"] == "<u2"
    datum = ImageMaskPair()
    datum.ParseFromString(buf)
    assert fields["img_height"] == datum.img_height and bytes(fields["labels"]) == datum.labels
    with pytest.raises(ValueError):
        tbuild.decode_image_mask_pair(buf[:-3])


def _records(n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        img = rng.integers(0, 4096, (16, 16, 1)).astype(np.uint16)
        msk = (rng.random((16, 16)) > 0.5).astype(np.uint8)
        out[f"tile{i:04d}:0,1".encode()] = (img, msk)
    return out


@pytest.mark.parametrize("writer, reader", [(JaxRecordWriter, RecordReader),
                                            (RecordWriter, JaxRecordReader)])
def test_record_store_interop(tmp_path, writer, reader):
    recs = _records(7, 0)
    db = str(tmp_path / "db.lmdb")
    with writer(db) as w:
        for k in reversed(list(recs)):  # unsorted puts; the index sorts
            w.put(k, tbuild.serialize_image_mask_pair(*recs[k]))
        w.put(b"tile0003:0,1", tbuild.serialize_image_mask_pair(*recs[b"tile0000:0,1"]))
    r = reader(db)
    try:
        assert r.keys() == sorted(recs) and len(r) == 7
        for i, k in enumerate(sorted(recs)):
            src = recs[b"tile0000:0,1"] if k == b"tile0003:0,1" else recs[k]
            img, msk = tbuild.deserialize_image_mask_pair(r.get_at(i))
            np.testing.assert_array_equal(img, src[0])
            assert r.get(k) == r.get_at(i)
    finally:
        r.close()


def test_record_reader_refuses_missing_and_unfinished(tmp_path):
    with pytest.raises(IOError, match="Missing Database"):
        RecordReader(str(tmp_path / "nope"))
    db = str(tmp_path / "partial")
    w = RecordWriter(db)
    w.put(b"a:0", b"xyz")
    w.abort()
    with pytest.raises(IOError):
        RecordReader(db)


@pytest.fixture(scope="module")
def reader_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("r") / "train.lmdb")
    recs = _records(9, 5)
    with RecordWriter(db) as w:
        for k, (img, msk) in recs.items():
            w.put(k, tbuild.serialize_image_mask_pair(img, msk))
    return db


@pytest.mark.parametrize("shuffle", [True, False])
def test_reader_yields_tpuseg_order(reader_db, shuffle):
    kw = dict(use_augmentation=False, shuffle=shuffle, num_workers=1, raw_mode=True,
              layout="nhwc", seed=11)
    got, want = [], []
    for cls, out in ((ImageReader, got), (JaxReader, want)):
        with cls(reader_db, **kw) as r:
            batches = r.batches(3)
            for _ in range(4):  # 12 samples: past the 9 keys, the walk restarts
                out.append(next(batches))
            batches.close()
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == np.uint16 and gm.dtype == np.uint8
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)


def test_reader_host_path_matches_tpuseg(reader_db):
    """Non-raw mode with host augmentation: the same seeded worker stream
    gives the same z-scored images and one-hot labels."""
    kw = dict(use_augmentation=True, shuffle=True, num_workers=1, layout="nhwc", seed=4)
    out = []
    for cls in (ImageReader, JaxReader):
        with cls(reader_db, **kw) as r:
            batches = r.batches(2)
            out.append(next(batches))
            batches.close()
    (gi, gl), (wi, wl) = out
    assert gi.dtype == np.float32 and gl.dtype == np.int32 and gl.shape == (2, 16, 16, 2)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)


def test_preprocess_and_host_augment_copies():
    rng = np.random.default_rng(9)
    img = rng.normal(500, 50, (16, 16, 2)).astype(np.float32)
    msk = (rng.random((16, 16)) > 0.5).astype(np.uint8)
    np.testing.assert_array_equal(tpre.zscore_normalize(img, channels_first=False),
                                  jpre.zscore_normalize(img, channels_first=False))
    np.testing.assert_array_equal(tpre.one_hot_labels(msk, 2), jpre.one_hot_labels(msk, 2))
    kw = dict(rotation_flag=True, reflection_flag=True, jitter_augmentation_severity=0.1,
              noise_augmentation_severity=0.02, scale_augmentation_severity=0.1,
              blur_augmentation_max_sigma=2.0, intensity_augmentation_severity=0.1)
    a = augment_image(img, msk, rng=np.random.default_rng(1), **kw)
    b = jax_augment_image(img, msk, rng=np.random.default_rng(1), **kw)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.fixture(scope="module")
def multiclass_db(tmp_path_factory):
    """12 records of 3-channel uint16 images with 4-class masks; keys list
    the classes present (as the database build writes them), so class 3
    is rare and class-balanced sampling changes the draw."""
    db = str(tmp_path_factory.mktemp("mc") / "train-mc.lmdb")
    rng = np.random.default_rng(0)
    with RecordWriter(db) as w:
        for i in range(12):
            img = rng.integers(0, 65535, (16, 16, 3), dtype=np.uint16)
            msk = rng.integers(0, 2, (16, 16)).astype(np.uint8)
            if i % 3 == 1:
                msk[msk == 1] = 2
            if i == 5:
                msk[:4][msk[:4] == 0] = 3
            classes = ",".join(str(c) for c in np.unique(msk))
            w.put(f"img{i:03d}:{classes}".encode(), tbuild.serialize_image_mask_pair(img, msk))
    return db


@pytest.mark.parametrize("raw_mode", [True, False])
def test_balanced_multiclass_reader_matches_tpuseg(multiclass_db, raw_mode):
    """balance_classes=True with K=4 classes over C=3 channels: the seeded
    readers draw the same records in the same order; raw samples are
    equal, and the host path gives equal augmented z-scored images and
    4-class one-hot labels."""
    kw = dict(use_augmentation=not raw_mode, balance_classes=True, shuffle=True,
              num_workers=1, number_classes=4, raw_mode=raw_mode, layout="nhwc", seed=21)
    out = []
    for cls in (ImageReader, JaxReader):
        with cls(multiclass_db, **kw) as r:
            assert [len(k) for k in r.keys] == [12, 8, 4, 1]
            batches = r.batches(4)
            out.append([next(batches) for _ in range(5)])
            batches.close()
    for (gi, gl), (wi, wl) in zip(*out):
        assert gi.shape == (4, 16, 16, 3)
        assert gl.shape == ((4, 16, 16) if raw_mode else (4, 16, 16, 4))
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if raw_mode:
        # class-balanced: the one record with class 3 is drawn far above 1/12
        drawn = np.concatenate([lbl for _, lbl in out[0]])
        assert (drawn == 3).any(axis=(1, 2)).sum() >= 2
