"""The port's reference-checkpoint export (tpuseg_torch/utils/tf_export.py,
cli/export_checkpoint.py) against tpuseg's import and Keras, on the CPU.

A port checkpoint (base 8, 2 channels, 3 classes, randomised BatchNorm)
exported as a reference ``tf.train.Checkpoint``:

- imported by tpuseg gives ``jax_bridge.state_dict_to_flax`` of the port's
  weights, exactly;
- imported back by the port gives its ``state_dict``, exactly;
- restored into the Keras reference model the reference's way
  (model.py:81-83), its softmax matches the port's ``probabilities``
  within the JAX test's tolerance (atol 2e-4, rtol 1e-3);
- a ``pixel_shuffle`` checkpoint and geometry flags that disagree with
  the checkpoint are refused.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpuseg.models.unet import UNet as JaxUNet  # noqa: E402
from tpuseg.train.steps import create_train_state as jax_train_state  # noqa: E402
from tpuseg.utils.checkpoint import restore_model_variables  # noqa: E402
from tpuseg.utils.tf_import import import_reference_checkpoint as jax_import  # noqa: E402
from tpuseg_torch.cli.export_checkpoint import main as export_cli  # noqa: E402
from tpuseg_torch.models.unet import UNet, init_unet  # noqa: E402
from tpuseg_torch.utils.checkpoint import save_model  # noqa: E402
from tpuseg_torch.utils.jax_bridge import state_dict_to_flax  # noqa: E402
from tpuseg_torch.utils.tf_export import (build_reference_keras_unet,  # noqa: E402
                                          export_reference_checkpoint, keras_weights)
from tpuseg_torch.utils.tf_import import load_reference_checkpoint  # noqa: E402
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

BASE = 8


def _port_model(seed, impl="conv_transpose"):
    g = torch.Generator().manual_seed(seed)
    model = init_unet(UNet(3, 2, BASE, torch.float32, impl), g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.num_features, generator=g) + 0.5)
                m.bias.copy_(torch.rand(m.num_features, generator=g) - 0.5)
                m.running_mean.copy_(torch.rand(m.num_features, generator=g) - 0.5)
                m.running_var.copy_(torch.rand(m.num_features, generator=g) + 0.5)
    return model.eval()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(port model, its checkpoint, the exported TF prefix)."""
    root = tmp_path_factory.mktemp("export")
    model = _port_model(11)
    src = str(root / "port.pt")
    save_model(src, model)
    prefix = export_cli(["--checkpoint_filepath", src, "--output_prefix",
                         str(root / "tf" / "ckpt"), "--number_classes", "3",
                         "--number_channels", "2", "--base_features", str(BASE)])
    return model, src, prefix


def test_export_then_tpuseg_import_is_exact(exported, tmp_path):
    model, _, prefix = exported
    out = str(tmp_path / "jax_ckpt")
    assert jax_import(prefix, out) == {"number_channels": 2, "base_features": BASE,
                                       "number_classes": 3}
    jmodel = JaxUNet(num_classes=3, base_features=BASE, dtype=jnp.float32)
    got = restore_model_variables(out, jax_train_state(jmodel, jax.random.PRNGKey(0), 2, 3e-4))
    want = state_dict_to_flax(model.state_dict())
    flat = jax.tree_util.tree_flatten_with_path
    (got_leaves, got_tree), (want_leaves, want_tree) = flat(got), flat(want)
    assert got_tree == want_tree
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


def test_export_then_port_import_round_trips(exported):
    model, _, prefix = exported
    back = load_reference_checkpoint(prefix)
    sd = model.state_dict()
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_exported_keras_model_matches_port(exported):
    model, _, prefix = exported
    kmodel = build_reference_keras_unet(3, 2, BASE)
    ckpt = tf.train.Checkpoint(optimizer=tf.keras.optimizers.Adam(), model=kmodel)
    ckpt.restore(prefix).expect_partial()
    x = np.random.default_rng(12).normal(size=(1, 64, 64, 2)).astype(np.float32)
    with torch.no_grad():
        ours = model.probabilities(torch.from_numpy(x)).numpy()
    theirs = kmodel(tf.constant(x), training=False).numpy()
    assert ours.shape == theirs.shape == (1, 64, 64, 3)
    np.testing.assert_allclose(ours, theirs, atol=2e-4, rtol=1e-3)


def test_keras_weights_order_and_layouts():
    """Weighted layers in build order: conv/deconv then its BatchNorm; the
    deconv kernel goes to Keras' (kh, kw, out, in) with a zero bias."""
    sd = _port_model(3).state_dict()
    layers = keras_weights(sd)
    assert [k for k, _ in layers[:4]] == ["conv", "bn", "conv", "bn"]
    assert layers[20][0] == "deconv"  # dec4up after 10 encoder conv/bn pairs
    kern, bias = layers[20][1]
    w = sd["dec4up.deconv.weight"].numpy()  # (in, out, 2, 2)
    assert kern.shape == (2, 2, w.shape[1], w.shape[0]) and not bias.any()
    np.testing.assert_array_equal(kern[1, 0], w[:, :, 1, 0].T)
    np.testing.assert_array_equal(layers[0][1][0],
                                  sd["enc1a.conv.weight"].numpy().transpose(2, 3, 1, 0))


def test_export_refuses_pixel_shuffle_and_mismatched_flags(exported, tmp_path):
    _, src, _ = exported
    with pytest.raises(ValueError, match="num_classes=2"):
        export_reference_checkpoint(src, str(tmp_path / "a" / "ckpt"), number_classes=2)
    with pytest.raises(ValueError, match="base_features=16"):
        export_cli(["--checkpoint_filepath", src, "--output_prefix", str(tmp_path / "b"),
                    "--base_features", "16"])
    ps = str(tmp_path / "ps.pt")
    save_model(ps, _port_model(4, "pixel_shuffle"))
    with pytest.raises(ValueError, match="pixel_shuffle"):
        export_reference_checkpoint(ps, str(tmp_path / "c" / "ckpt"))
