"""The port's reference-checkpoint import (tpuseg_torch/utils/tf_import.py,
cli/import_checkpoint.py) against tpuseg's, on the CPU.

One Keras reference checkpoint (randomised BatchNorm, 2 channels, 3
classes, written as the reference writes it: train.py:96) goes through
both packages' import. In both schemas (Keras 3 as this TF writes it; the
same arrays renamed to the Keras 2 ``layer_with_weights-K`` schema by the
port's bundle writer) the port's ``state_dict`` equals
``jax_bridge.flax_to_state_dict`` of the JAX import's restored variables
bit for bit, and the geometries agree. The imported model's softmax
matches Keras' within the JAX test's tolerance (atol 2e-4, rtol 1e-3;
f32 conv sums run in another order in TF and PyTorch). The written
training checkpoint serves through ``cli.inference`` and resumes at step
0. The refusals are tpuseg's, plus a non-zero deconv bias.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_tf_parity import FEATURES, build_keras_unet  # noqa: E402
from tpuseg.models.unet import UNet as JaxUNet  # noqa: E402
from tpuseg.train.steps import create_train_state as jax_train_state  # noqa: E402
from tpuseg.utils.checkpoint import restore_model_variables  # noqa: E402
from tpuseg.utils.tf_import import import_reference_checkpoint as jax_import  # noqa: E402
from tpuseg_torch.cli.import_checkpoint import main as import_cli  # noqa: E402
from tpuseg_torch.cli.inference import main as infer_cli  # noqa: E402
from tpuseg_torch.models.unet import UNet  # noqa: E402
from tpuseg_torch.train.steps import create_train_state  # noqa: E402
from tpuseg_torch.utils import tf_bundle  # noqa: E402
from tpuseg_torch.utils.checkpoint import load_model, restore_train_state  # noqa: E402
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict  # noqa: E402
from tpuseg_torch.utils.tf_import import (import_reference_checkpoint,  # noqa: E402
                                          load_reference_checkpoint)
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

GEOMETRY = {"number_channels": 2, "base_features": FEATURES[0], "number_classes": 3}


def _randomize_bn(kmodel, rng):
    for layer in kmodel.layers:
        if isinstance(layer, tf.keras.layers.BatchNormalization):
            g, b, m, v = layer.get_weights()
            layer.set_weights([rng.uniform(0.5, 1.5, g.shape).astype(np.float32),
                               rng.uniform(-0.5, 0.5, b.shape).astype(np.float32),
                               rng.uniform(-0.5, 0.5, m.shape).astype(np.float32),
                               rng.uniform(0.5, 1.5, v.shape).astype(np.float32)])


def _as_keras2(prefix, out_prefix):
    """The same arrays under Keras 2's names: ``layer_with_weights-K``
    counts weighted layers only, in the order Keras 3 numbers them."""
    reader = tf_bundle.BundleReader(prefix)
    ops = {}
    for name in reader.entries:
        m = re.match(r"model/_operations/(\d+)/_?(\w+)/\.ATTRIBUTES/VARIABLE_VALUE$", name)
        if m:
            ops.setdefault(int(m.group(1)), {})[m.group(2)] = reader.get_tensor(name)
    tensors = {}
    for k, op in enumerate(ops[i] for i in sorted(ops)):
        for attr, arr in op.items():
            tensors[f"model/layer_with_weights-{k}/{attr}/.ATTRIBUTES/VARIABLE_VALUE"] = arr
    tensors["optimizer/iter/.ATTRIBUTES/VARIABLE_VALUE"] = np.int64(0)
    return tf_bundle.write_bundle(out_prefix, tensors)


@pytest.fixture(scope="module")
def keras_ckpt(tmp_path_factory):
    """(Keras model, {schema: TF checkpoint prefix})."""
    rng = np.random.default_rng(7)
    kmodel = build_keras_unet(num_classes=3, channels=2)
    kmodel(tf.zeros((1, 32, 32, 2)))
    _randomize_bn(kmodel, rng)
    root = tmp_path_factory.mktemp("ref")
    ckpt = tf.train.Checkpoint(optimizer=tf.keras.optimizers.Adam(), model=kmodel)
    keras3 = ckpt.write(str(root / "keras3" / "checkpoint" / "ckpt"))
    keras2 = _as_keras2(keras3, str(root / "keras2" / "checkpoint" / "ckpt"))
    return kmodel, {"keras3": keras3, "keras2": keras2}


@pytest.mark.parametrize("schema", ["keras3", "keras2"])
def test_import_equals_tpuseg_import(keras_ckpt, tmp_path, schema):
    _, prefixes = keras_ckpt
    jax_out = str(tmp_path / "jax_ckpt")
    jax_geometry = jax_import(prefixes[schema], jax_out)
    model = JaxUNet(num_classes=3, base_features=FEATURES[0], dtype=jnp.float32)
    variables = restore_model_variables(
        jax_out, jax_train_state(model, jax.random.PRNGKey(0), 2, 3e-4))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, variables))

    port_out = str(tmp_path / "port" / "ckpt")
    geometry = import_reference_checkpoint(prefixes[schema], port_out)
    assert geometry == jax_geometry == GEOMETRY
    got = load_reference_checkpoint(prefixes[schema])
    stored = torch.load(port_out, weights_only=True)["state_dict"]
    assert set(got) == set(want) == set(stored)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
        assert torch.equal(stored[k], want[k]), k


def test_import_runs_without_tensorflow(keras_ckpt, tmp_path):
    """In a fresh interpreter the import CLI reads the checkpoint and never
    loads TensorFlow (the card's machine has none)."""
    _, prefixes = keras_ckpt
    code = ("import sys\n"
            "from tpuseg_torch.cli.import_checkpoint import main\n"
            f"g = main(['--tf_checkpoint', {prefixes['keras2']!r}, "
            f"'--output_folder', {str(tmp_path)!r}])\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('tensorflow', 'keras', 'jax', 'tpuseg') or m.startswith('google.protobuf'))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "'number_classes': 3" in res.stdout


def test_probabilities_match_keras(keras_ckpt, tmp_path):
    kmodel, prefixes = keras_ckpt
    out = str(tmp_path / "imported")
    assert import_cli(["--tf_checkpoint", prefixes["keras3"], "--output_folder", out]) \
        == GEOMETRY
    model = load_model(os.path.join(out, "ckpt"), dtype="float32")
    x = np.random.default_rng(8).normal(size=(1, 64, 64, 2)).astype(np.float32)
    with torch.no_grad():
        ours = model.probabilities(torch.from_numpy(x)).numpy()
    theirs = kmodel(tf.constant(x), training=False).numpy()
    assert ours.shape == theirs.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)


def test_imported_checkpoint_serves_and_resumes(keras_ckpt, tmp_path):
    from tpuseg_torch.utils.imagio import imread, imwrite

    _, prefixes = keras_ckpt
    out = str(tmp_path / "imported")
    import_cli(["--tf_checkpoint", os.path.dirname(prefixes["keras3"]), "--output_folder", out,
                "--learning_rate", "5e-4"])
    ckpt = os.path.join(out, "ckpt")
    imgdir = str(tmp_path / "imgs")
    os.makedirs(imgdir)
    imwrite(os.path.join(imgdir, "a.tif"),
            np.random.default_rng(9).integers(0, 4000, (32, 48, 2)).astype(np.uint16))
    written = infer_cli(["--checkpoint_filepath", ckpt, "--image_folder", imgdir,
                         "--output_folder", str(tmp_path / "masks"), "--number_classes", "3",
                         "--number_channels", "2", "--base_features", str(FEATURES[0]),
                         "--device", "cpu", "--quantize", "none"])
    mask = imread(written[0])
    assert mask.shape == (32, 48) and set(np.unique(mask)) <= {0, 1, 2}

    state = create_train_state(UNet(3, 2, FEATURES[0], "float32"), 1, 3e-4, "cpu")
    seeded = state.aug_generator.get_state()
    restore_train_state(ckpt, state)
    assert torch.equal(state.aug_generator.get_state(), seeded)  # the run's own seed
    assert state.step == 0 and state.lr == 5e-4  # step 0: the warmup epoch still runs
    assert state.optimizer.param_groups[0]["step"] == 0 and not state.optimizer.state
    want = load_reference_checkpoint(prefixes["keras3"])
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_import_rejects_non_reference_checkpoint(tmp_path):
    ckpt = tf.train.Checkpoint(thing=tf.Variable([1.0]))
    path = str(tmp_path / "bogus")
    ckpt.write(path)
    with pytest.raises(IOError, match="not a reference UNet checkpoint"):
        import_reference_checkpoint(path, str(tmp_path / "out" / "ckpt"))
    with pytest.raises(IOError, match="no TF checkpoint"):
        import_reference_checkpoint(str(tmp_path / "out"), str(tmp_path / "out2" / "ckpt"))


def test_import_refuses_a_nonzero_deconv_bias(keras_ckpt, tmp_path):
    _, prefixes = keras_ckpt
    reader = tf_bundle.BundleReader(prefixes["keras2"])
    tensors = {k: reader.get_tensor(k) for k, e in reader.entries.items()}
    # the first deconv (dec4up) is the 11th weighted conv layer: layer 20
    name = "model/layer_with_weights-20/bias/.ATTRIBUTES/VARIABLE_VALUE"
    assert tensors["model/layer_with_weights-20/kernel/.ATTRIBUTES/VARIABLE_VALUE"].shape[:2] \
        == (2, 2)
    tensors[name] = np.full_like(tensors[name], 1e-3)
    prefix = tf_bundle.write_bundle(str(tmp_path / "ckpt"), tensors)
    with pytest.raises(ValueError, match="deconv bias is non-zero"):
        import_reference_checkpoint(prefix, str(tmp_path / "out" / "ckpt"))
