"""The port's numpy reader and writer of TensorFlow's tensor bundle
(tpuseg_torch/utils/tf_bundle.py) against TensorFlow's own, on the CPU.

- reader: every variable of a checkpoint TF writes the reference's way
  (``tf.train.Checkpoint(optimizer, model).write``, Keras 3 schema here)
  has the name, dtype, shape and bytes ``tf.train.load_checkpoint`` gives,
  the optimizer's scalars included; the object-graph string entry is
  listed and not read;
- writer: TF reads back what the port writes, bit for bit;
- a Keras 2 schema checkpoint (``layer_with_weights-K``, which this TF
  cannot write) from the port's writer imports through both packages'
  ``load_reference_checkpoint`` to equal weights;
- directory resolution, CRC checks and refusals.
"""

import struct

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from tests.test_tf_parity import build_keras_unet  # noqa: E402
from tests.test_torch_tf_export import _port_model  # noqa: E402
from tpuseg.utils import tf_import as jax_tf_import  # noqa: E402
from tpuseg_torch.utils import tf_bundle  # noqa: E402
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict  # noqa: E402
from tpuseg_torch.utils.tf_export import keras2_checkpoint_tensors  # noqa: E402
from tpuseg_torch.utils.tf_import import load_reference_checkpoint  # noqa: E402
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tf_ckpt(tmp_path_factory):
    kmodel = build_keras_unet(num_classes=3, channels=2)
    kmodel(tf.zeros((1, 32, 32, 2)))
    ckpt = tf.train.Checkpoint(optimizer=tf.keras.optimizers.Adam(), model=kmodel)
    return ckpt.write(str(tmp_path_factory.mktemp("tfck") / "checkpoint" / "ckpt"))


def _slow_crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    return c ^ 0xFFFFFFFF


def test_crc32c_known_vector_and_reference():
    assert tf_bundle.crc32c(b"123456789") == 0xE3069283
    assert tf_bundle.crc32c(b"") == 0
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 5, 63, 64, 257, 4099, 20001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tf_bundle.crc32c(data) == _slow_crc32c(data), n
        # extending a CRC is a CRC of the concatenation
        assert tf_bundle.crc32c(data[n // 3:], tf_bundle.crc32c(data[:n // 3])) == \
            _slow_crc32c(data), n
    for v in (0, 1, 0xE3069283, 0xFFFFFFFF):
        assert tf_bundle.unmask_crc(tf_bundle.mask_crc(v)) == v


def test_reader_matches_tf(tf_ckpt):
    ref = tf.train.load_checkpoint(tf_ckpt)
    dtypes, shapes = ref.get_variable_to_dtype_map(), ref.get_variable_to_shape_map()
    got = tf_bundle.BundleReader(tf_ckpt)
    assert set(got.entries) == set(dtypes)
    assert got.entries["_CHECKPOINTABLE_OBJECT_GRAPH"].dtype == "string"
    scalars = [k for k in got.entries if k.startswith("optimizer/")]
    assert scalars and all(got.entries[k].shape == () for k in scalars)
    for name, e in got.entries.items():
        assert e.dtype == dtypes[name].name and list(e.shape) == list(shapes[name]), name
        if e.dtype == "string":
            with pytest.raises(IOError, match="string"):
                got.get_tensor(name)
            continue
        a, b = got.get_tensor(name), ref.get_tensor(name)
        assert a.dtype == b.dtype and a.shape == np.shape(b), name
        assert a.tobytes() == np.asarray(b).tobytes(), name


def test_writer_is_read_by_tf(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {"model/w": rng.normal(size=(3, 3, 2, 8)).astype(np.float32),
               "model/b": rng.normal(size=(8,)).astype(np.float32),
               "optimizer/iter": np.int64(42),
               "x/i32": np.arange(12, dtype=np.int32).reshape(3, 4),
               "x/empty": np.zeros((0, 4), np.float32)}
    prefix = tf_bundle.write_bundle(str(tmp_path / "ckpt"), tensors)
    ref = tf.train.load_checkpoint(prefix)
    assert dict(tf.train.list_variables(prefix)) == {k: list(np.shape(v))
                                                     for k, v in tensors.items()}
    for name, want in tensors.items():
        got = np.asarray(ref.get_tensor(name))
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), name
    back = tf_bundle.BundleReader(prefix)
    for name, want in tensors.items():
        assert back.get_tensor(name).tobytes() == np.asarray(want).tobytes(), name


def test_keras2_schema_imports_equal_in_both_packages(tmp_path):
    sd = _port_model(2).state_dict()
    prefix = tf_bundle.write_bundle(str(tmp_path / "ckpt"), keras2_checkpoint_tensors(sd))
    params, stats = jax_tf_import.load_reference_checkpoint(prefix)
    want = flax_to_state_dict({"params": params, "batch_stats": stats})
    got = load_reference_checkpoint(prefix)
    assert set(got) == set(want) == set(sd)
    for k in sd:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k


def test_directory_resolution(tmp_path):
    t = {"v": np.zeros(1, np.float32)}
    folder = tmp_path / "ckpts"
    for n in (9, 12):
        tf_bundle.write_bundle(str(folder / f"ckpt-{n}"), t)
    # no state file: numerically newest, not lexicographically last
    assert tf_bundle.resolve_prefix(str(folder)) == str(folder / "ckpt-12")
    # a state file (as Checkpoint.save keeps) names the one to use, as TF reads it
    (folder / "checkpoint").write_text('model_checkpoint_path: "ckpt-9"\n'
                                       'all_model_checkpoint_paths: "ckpt-9"\n')
    assert tf.train.latest_checkpoint(str(folder)) == str(folder / "ckpt-9")
    assert tf_bundle.resolve_prefix(str(folder)) == str(folder / "ckpt-9")
    assert tf_bundle.BundleReader(str(folder)).prefix == str(folder / "ckpt-9")
    with pytest.raises(IOError, match="no TF checkpoint"):
        tf_bundle.resolve_prefix(str(tmp_path))


@pytest.mark.parametrize("where", ["data", "index"])
def test_corrupted_byte_fails_the_crc(tmp_path, where):
    prefix = tf_bundle.write_bundle(str(tmp_path / "ckpt"),
                                    {"w": np.arange(64, dtype=np.float32)})
    path = prefix + (".data-00000-of-00001" if where == "data" else ".index")
    raw = bytearray(open(path, "rb").read())
    raw[8] ^= 0x01  # inside the tensor's bytes / inside the data block
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC32C mismatch"):
        tf_bundle.BundleReader(prefix).get_tensor("w")


def test_refuses_compressed_blocks_and_sliced_entries(tmp_path):
    prefix = tf_bundle.write_bundle(str(tmp_path / "ckpt"), {"w": np.ones(4, np.float32)})
    raw = bytearray(open(prefix + ".index", "rb").read())
    # the data block starts the file: its size from the index block's handle
    footer = bytes(raw[-tf_bundle.FOOTER_SIZE:])
    _, _, pos = tf_bundle._handle(footer)
    index_at, index_size, _ = tf_bundle._handle(footer, pos)
    (_, handle), = tf_bundle._block_entries(bytes(raw[index_at:index_at + index_size]), "t")
    _, size, _ = tf_bundle._handle(handle)
    raw[size] = 1  # compression type snappy, its CRC fixed: only the type is wrong
    raw[size + 1:size + 5] = struct.pack(
        "<I", tf_bundle.mask_crc(tf_bundle.crc32c(bytes(raw[:size + 1]))))
    open(prefix + ".index", "wb").write(bytes(raw))
    with pytest.raises(IOError, match="compressed"):
        tf_bundle.BundleReader(prefix)
    sliced = tf_bundle.proto_key(1, 0) + b"\x01" + tf_bundle.proto_bytes(7, b"")
    with pytest.raises(IOError, match="sliced"):
        tf_bundle.parse_entry("v", sliced)


def test_bad_magic_is_refused(tmp_path):
    (tmp_path / "x.index").write_bytes(b"\x00" * 64)
    with pytest.raises(IOError, match="magic"):
        tf_bundle.BundleReader(str(tmp_path / "x"))
