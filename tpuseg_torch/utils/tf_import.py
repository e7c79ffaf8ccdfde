"""Import a reference TensorFlow checkpoint into the port, without TensorFlow.

Counterpart of ``tpuseg/utils/tf_import.py``. The reference's artifacts are
``tf.train.Checkpoint(optimizer, model)`` directories (train.py:96,
181-184). They are read here variable by variable through
:mod:`tpuseg_torch.utils.tf_bundle`, a numpy reader of TensorFlow's tensor
bundle, so a reference checkpoint imports on a machine that has no
TensorFlow (the card's).

Weighted layers are matched positionally in the reference's build order
(model.py:85-146), in either checkpoint schema:

- Keras 2 (TF 2.0-2.15): ``model/layer_with_weights-{K}/{attr}/.ATTRIBUTES/VARIABLE_VALUE``;
- Keras 3 (TF >= 2.16): ``model/_operations/{K}/{attr}/...`` (``_kernel``).

Keras arrays -> the port's ``state_dict``:

- Conv2D kernel HWIO ``(kh, kw, in, out)`` -> OIHW: ``transpose(3, 2, 0, 1)``;
- Conv2DTranspose kernel ``(kh, kw, out, in)`` -> ``ConvTranspose2d``'s
  ``(in, out, kh, kw)``: also ``transpose(3, 2, 0, 1)``, with no flip. The
  JAX import flips both spatial axes into flax's layout
  (``tpuseg/utils/tf_import.py:121-122``) and the bridge flips them back
  (``jax_bridge._conv_transpose``); the flips cancel. Its bias must be
  zero (its gradient vanishes through the BatchNorm after it, so the
  reference's training leaves it at its zero init); a non-zero one is
  refused rather than dropped;
- BatchNorm ``gamma/beta/moving_mean/moving_variance`` ->
  ``weight/bias/running_mean/running_var``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from tpuseg_torch.utils.tf_bundle import BundleReader

_VAR_RE = re.compile(
    r"model/(?:layer_with_weights-|_operations/)(\d+)/(_?\w+)/\.ATTRIBUTES/VARIABLE_VALUE$")


def block_sequence() -> List[Tuple[str, str]]:
    """(block_name, kind) for every weighted conv/deconv layer, in the
    reference's Keras build order; each is followed by its BatchNorm."""
    seq: List[Tuple[str, str]] = []
    for b in ["enc1", "enc2", "enc3", "enc4", "bottleneck"]:
        seq += [(f"{b}a", "conv"), (f"{b}b", "conv")]
    for b in ["dec4", "dec3", "dec2", "dec1"]:
        seq += [(f"{b}up", "deconv"), (f"{b}a", "conv"), (f"{b}b", "conv")]
    seq.append(("head", "conv"))
    return seq


def _kernel_to_torch(kernel: np.ndarray) -> np.ndarray:
    """Keras conv HWIO, or Conv2DTranspose ``(kh, kw, out, in)``, to the
    port's OIHW or ``(in, out, kh, kw)``."""
    return np.ascontiguousarray(np.asarray(kernel, np.float32).transpose(3, 2, 0, 1))


def load_reference_checkpoint(ckpt_path: str) -> Dict[str, torch.Tensor]:
    """Read a reference TF checkpoint (a prefix or its directory) into the
    port U-Net's ``state_dict`` (``deconv_impl="conv_transpose"``)."""
    reader = BundleReader(ckpt_path)
    by_layer: Dict[int, Dict[str, str]] = {}
    for name in reader.entries:
        m = _VAR_RE.match(name)
        if m:
            by_layer.setdefault(int(m.group(1)), {})[m.group(2).lstrip("_")] = name
    ordered = [by_layer[i] for i in sorted(by_layer)
               if "kernel" in by_layer[i] or "gamma" in by_layer[i]]

    seq = block_sequence()
    if len(ordered) != 2 * len(seq):
        raise IOError(
            f"found {len(ordered)} weighted layers, expected {2 * len(seq)} — "
            "not a reference UNet checkpoint "
            "(tf.train.Checkpoint(optimizer, model), model.py:81-83)?")

    def get(layer: Dict[str, str], attr: str) -> np.ndarray:
        if attr not in layer:
            raise IOError(f"weighted layer missing '{attr}' (has {sorted(layer)}) — "
                          "not a reference UNet checkpoint?")
        return reader.get_tensor(layer[attr])

    out: Dict[str, np.ndarray] = {}
    layers = iter(ordered)
    for block, kind in seq:
        wl = next(layers)
        if kind == "conv":
            out[f"{block}.conv.weight"] = _kernel_to_torch(get(wl, "kernel"))
            out[f"{block}.conv.bias"] = get(wl, "bias")
        else:
            out[f"{block}.deconv.weight"] = _kernel_to_torch(get(wl, "kernel"))
            if "bias" in wl:
                bias = get(wl, "bias")
                if np.abs(bias).max() > 1e-6:
                    raise ValueError(
                        f"{block} deconv bias is non-zero (max "
                        f"{np.abs(bias).max():.3e}) — expected identically "
                        "zero (its gradient vanishes through BatchNorm); "
                        "refusing a lossy import")
        bn = next(layers)
        for attr, key in (("gamma", "weight"), ("beta", "bias"),
                          ("moving_mean", "running_mean"), ("moving_variance", "running_var")):
            out[f"{block}.bn.{key}"] = get(bn, attr)
    sd = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in out.items()}
    for block, _ in seq:
        sd[f"{block}.bn.num_batches_tracked"] = torch.tensor(0)
    return sd


def import_reference_checkpoint(ckpt_path: str, output_path: str,
                                learning_rate: float = 3e-4) -> dict:
    """Full import: read the TF checkpoint, check it against a U-Net of the
    inferred geometry, and write a training checkpoint at ``output_path``
    (fresh Adam state, step 0, ``learning_rate``, no generator states) that
    ``tpuseg_torch.cli.inference`` serves and ``cli.train
    --resume_checkpoint`` resumes (a resume from step 0 runs the warmup
    epoch). Returns the inferred geometry."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.train.steps import create_train_state
    from tpuseg_torch.utils.checkpoint import train_checkpoint, write_checkpoint

    sd = load_reference_checkpoint(ckpt_path)
    enc1a = sd["enc1a.conv.weight"]
    geometry = {
        "number_channels": int(enc1a.shape[1]),
        "base_features": int(enc1a.shape[0]),
        "number_classes": int(sd["head.conv.weight"].shape[0]),
    }
    model = UNet(geometry["number_classes"], geometry["number_channels"],
                 geometry["base_features"], torch.float32, "conv_transpose")
    template = model.state_dict()
    ta = {k: tuple(v.shape) for k, v in template.items()}
    tb = {k: tuple(v.shape) for k, v in sd.items()}
    if ta != tb:
        raise ValueError(f"imported weights do not match the UNet template:\n{ta}\nvs\n{tb}")
    state = create_train_state(model, 0, learning_rate, "cpu")
    model.load_state_dict(sd)
    doc = train_checkpoint(state)
    # no generator states: they are the device's kind (a CPU generator's
    # state does not load into a CUDA one), and a run resumed from step 0
    # draws from its own seed
    del doc["rng"]
    write_checkpoint(output_path, doc)
    return geometry
