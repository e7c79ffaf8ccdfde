"""Orbax <-> port checkpoint conversion (scripts/convert_orbax_checkpoint.py)
and the inverse weight bridge (jax_bridge.state_dict_to_flax), on the CPU.

- ``state_dict_to_flax(flax_to_state_dict(v)) == v`` bit for bit, for both
  deconv forms;
- a tpuseg orbax checkpoint converted to the port holds
  ``flax_to_state_dict`` of ``restore_model_variables``, exactly;
- a port checkpoint converted to orbax restores in tpuseg to
  ``state_dict_to_flax`` of its weights, exactly, and serves there.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.models.unet import UNet as JaxUNet
from tpuseg.train.steps import create_train_state
from tpuseg.utils.checkpoint import restore_model_variables, save_checkpoint
from tpuseg_torch.utils.checkpoint import load_model, save_model
from tpuseg_torch.utils.jax_bridge import flax_to_state_dict, state_dict_to_flax, unet_from_flax

from test_torch_unet import jax_model_and_vars
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "convert_orbax_checkpoint", os.path.join(ROOT, "scripts", "convert_orbax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_equal(got, want):
    a, b = _leaves(got), _leaves(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_state_dict_to_flax_inverts_the_bridge(impl):
    _, variables = jax_model_and_vars(impl, feats=4, ncls=3, channels=2)
    _assert_trees_equal(state_dict_to_flax(flax_to_state_dict(variables, impl), impl),
                        variables)


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_orbax_to_port(tmp_path, impl):
    model, variables = jax_model_and_vars(impl, feats=4, ncls=3, channels=2)
    state = create_train_state(model, jax.random.PRNGKey(0), 2, 3e-4)
    state = state.replace(params=jax.tree_util.tree_map(jnp.asarray, variables["params"]),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    orbax = str(tmp_path / "orbax")
    save_checkpoint(orbax, state)
    port = str(tmp_path / "port.pt")
    _script().main(["--to", "port", "--orbax_checkpoint", orbax, "--port_checkpoint", port,
                    "--number_classes", "3", "--number_channels", "2", "--base_features", "4",
                    "--deconv_impl", impl])
    restored = restore_model_variables(orbax, create_train_state(
        JaxUNet(num_classes=3, base_features=4, deconv_impl=impl), jax.random.PRNGKey(1), 2,
        3e-4))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, restored), impl)
    got = load_model(port, dtype="float32")
    assert got.config() == {"num_classes": 3, "num_channels": 2, "base_features": 4,
                            "deconv_impl": impl}
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("impl", ["conv_transpose", "pixel_shuffle"])
def test_port_to_orbax(tmp_path, impl):
    _, variables = jax_model_and_vars(impl, feats=4, ncls=3, channels=2)
    port_model = unet_from_flax(variables, 3, 2, 4, torch.float32, impl)
    port = str(tmp_path / "port.pt")
    save_model(port, port_model)
    orbax = str(tmp_path / "orbax")
    _script().main(["--to", "orbax", "--port_checkpoint", port, "--orbax_checkpoint", orbax])
    jmodel = JaxUNet(num_classes=3, base_features=4, dtype=jnp.float32, deconv_impl=impl)
    restored = restore_model_variables(orbax, create_train_state(
        jmodel, jax.random.PRNGKey(1), 2, 3e-4))
    _assert_trees_equal(restored, state_dict_to_flax(port_model.state_dict(), impl))
    _assert_trees_equal(restored, variables)
    # and tpuseg serves it: logits of the restored variables equal the port's
    x = np.random.default_rng(2).normal(0, 1, (1, 32, 32, 2)).astype(np.float32)
    want = np.asarray(jmodel.apply(restored, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_script_needs_geometry_for_port(tmp_path):
    with pytest.raises(SystemExit):
        _script().main(["--to", "port", "--orbax_checkpoint", str(tmp_path),
                        "--port_checkpoint", str(tmp_path / "p.pt")])
