"""Export a port checkpoint as a reference TensorFlow checkpoint.

Counterpart of ``tpuseg/utils/tf_export.py`` and the inverse of
:mod:`tpuseg_torch.utils.tf_import`: build the reference Keras graph
(UNet/model.py:85-146), load the port's weights into it, and write a
``tf.train.Checkpoint(optimizer, model)`` with the reference's object graph
(train.py:96), so a port-trained model drops into the reference's
``inference.py`` (model.py:81-83). This half needs TensorFlow, imported
inside the functions that use it; its output is for a TF deployment.

The weight mapping itself is numpy (:func:`keras_weights`):

- Conv2D: OIHW -> HWIO ``transpose(2, 3, 1, 0)``, bias as is;
- Conv2DTranspose: ``(in, out, kh, kw)`` -> Keras' ``(kh, kw, out, in)``,
  the same ``transpose(2, 3, 1, 0)``; bias the zero vector the reference's
  training leaves it at (its gradient vanishes through the BatchNorm);
- BatchNorm: weight/bias/running_mean/running_var ->
  gamma/beta/moving_mean/moving_variance.

:func:`keras2_checkpoint_tensors` names those arrays as a Keras 2
``tf.train.Checkpoint`` does, for :func:`tf_bundle.write_bundle
<tpuseg_torch.utils.tf_bundle.write_bundle>` to write a reference-layout
checkpoint where TensorFlow is absent.

Schema caveat (as in the JAX package): variable paths follow the
*installed* Keras' object graph (``model/layer_with_weights-K`` under
Keras 2, ``model/_operations/K`` under Keras 3), and a restore only
matches a checkpoint written under the same major; the export prints
which one it wrote (the importer reads both).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpuseg_torch.utils.tf_import import block_sequence

KERAS_ATTRS = {"conv": ("kernel", "bias"), "deconv": ("kernel", "bias"),
               "bn": ("gamma", "beta", "moving_mean", "moving_variance")}


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t, np.float32)


def keras_weights(state_dict: Dict[str, torch.Tensor]) -> List[Tuple[str, List[np.ndarray]]]:
    """The port's ``state_dict`` (``conv_transpose`` deconvs) as Keras layer
    weights, one ``(kind, arrays)`` per weighted layer in the reference's
    build order: each conv or deconv, then its BatchNorm."""
    out: List[Tuple[str, List[np.ndarray]]] = []
    for block, kind in block_sequence():
        if kind == "deconv":
            kern = _np(state_dict[f"{block}.deconv.weight"])
            if kern.ndim != 4 or kern.shape[2:] != (2, 2):
                raise ValueError(f"{block}: deconv weight {kern.shape} is not a 2x2 "
                                 "ConvTranspose2d (in, out, 2, 2) kernel")
            out.append(("deconv", [np.ascontiguousarray(kern.transpose(2, 3, 1, 0)),
                                   np.zeros(kern.shape[1], np.float32)]))
        else:
            out.append(("conv", [
                np.ascontiguousarray(_np(state_dict[f"{block}.conv.weight"]).transpose(2, 3, 1, 0)),
                _np(state_dict[f"{block}.conv.bias"])]))
        out.append(("bn", [_np(state_dict[f"{block}.bn.{k}"])
                           for k in ("weight", "bias", "running_mean", "running_var")]))
    return out


def keras2_checkpoint_tensors(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The model variables of a Keras 2 ``tf.train.Checkpoint(model=...)``
    holding ``state_dict``: ``model/layer_with_weights-K/{attr}/.ATTRIBUTES/
    VARIABLE_VALUE`` with K counting weighted layers in build order."""
    tensors: Dict[str, np.ndarray] = {}
    for k, (kind, arrays) in enumerate(keras_weights(state_dict)):
        for attr, arr in zip(KERAS_ATTRS[kind], arrays):
            tensors[f"model/layer_with_weights-{k}/{attr}/.ATTRIBUTES/VARIABLE_VALUE"] = arr
    return tensors


def build_reference_keras_unet(num_classes: int, channels: int, base_features: int = 64):
    """The reference graph (model.py:85-146) in Keras, channels_last (the
    reference's channels_first is a GPU layout choice, model.py:35; TF
    restores by object graph, not by layout)."""
    import tensorflow as tf

    L = tf.keras.layers
    features = [base_features * m for m in (1, 2, 4, 8, 16)]
    inp = tf.keras.Input(shape=(None, None, channels))

    def conv_block(x, f, k=3):
        x = L.Conv2D(f, k, padding="same", activation="relu")(x)  # model.py:28-37
        return L.BatchNormalization(axis=-1)(x)

    skips = []
    x = inp
    for f in features[:-1]:
        x = conv_block(conv_block(x, f), f)
        if f == features[-2]:
            x = L.Dropout(0.5)(x)  # model.py:105
        skips.append(x)
        x = L.MaxPool2D(2)(x)  # model.py:50-53
    x = conv_block(conv_block(x, features[-1]), features[-1])
    x = L.Dropout(0.5)(x)  # model.py:112
    for f, skip in zip(reversed(features[:-1]), reversed(skips)):
        x = L.Conv2DTranspose(f, 2, strides=2, padding="same")(x)  # model.py:39-48
        x = L.BatchNormalization(axis=-1)(x)
        x = L.Concatenate(axis=-1)([skip, x])  # model.py:55-58
        x = conv_block(conv_block(x, f), f)
    x = conv_block(x, num_classes, k=1)  # model.py:136 (BN'd 1x1 head)
    out = L.Softmax(axis=-1)(x)  # model.py:142
    return tf.keras.Model(inp, out)


def load_port_into_keras(kmodel, state_dict: Dict[str, torch.Tensor]) -> None:
    """Assign the port's weights into the Keras reference model, matching
    weighted layers positionally in the reference's build order."""
    import tensorflow as tf

    # under Keras 2 Conv2DTranspose subclasses Conv2D: a bare isinstance
    # would also collect the 4 deconvs and shift every assignment after
    # dec4a; Keras 3 has no such subclassing
    convs = [l for l in kmodel.layers
             if isinstance(l, tf.keras.layers.Conv2D)
             and not isinstance(l, tf.keras.layers.Conv2DTranspose)]
    deconvs = [l for l in kmodel.layers if isinstance(l, tf.keras.layers.Conv2DTranspose)]
    bns = [l for l in kmodel.layers if isinstance(l, tf.keras.layers.BatchNormalization)]
    targets = {"conv": iter(convs), "deconv": iter(deconvs), "bn": iter(bns)}
    for kind, arrays in keras_weights(state_dict):
        next(targets[kind]).set_weights(arrays)
    for kind, rest in targets.items():
        if next(rest, None) is not None:
            raise ValueError(f"the Keras model has more {kind} layers than the U-Net")


def _read_port_checkpoint(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    doc = torch.load(path, map_location="cpu", weights_only=True)
    return doc["config"], doc["state_dict"]


def export_reference_checkpoint(checkpoint_path: str, output_prefix: str,
                                number_classes: Optional[int] = None,
                                number_channels: Optional[int] = None,
                                base_features: Optional[int] = None,
                                learning_rate: float = 3e-4) -> str:
    """Port checkpoint (either kind) -> reference ``tf.train.Checkpoint``
    written at ``output_prefix``. The geometry is the checkpoint's own
    ``config``; any of ``number_classes``/``number_channels``/
    ``base_features`` given must agree with it. Returns the written prefix."""
    import tensorflow as tf

    config, state_dict = _read_port_checkpoint(checkpoint_path)
    if config.get("deconv_impl", "conv_transpose") != "conv_transpose":
        raise ValueError(
            f"{checkpoint_path} holds a {config['deconv_impl']!r} U-Net; the reference "
            "graph has a transposed conv (model.py:39-48), so only conv_transpose "
            "checkpoints export")
    asked = {"num_classes": number_classes, "num_channels": number_channels,
             "base_features": base_features}
    bad = {k: (v, config[k]) for k, v in asked.items() if v is not None and v != config[k]}
    if bad:
        raise ValueError(f"{checkpoint_path} holds a U-Net {config}; the flags ask for "
                         + ", ".join(f"{k}={v} (checkpoint: {c})" for k, (v, c) in bad.items()))

    kmodel = build_reference_keras_unet(config["num_classes"], config["num_channels"],
                                        config["base_features"])
    load_port_into_keras(kmodel, state_dict)
    # the reference's exact object graph: train.py:96
    ckpt = tf.train.Checkpoint(optimizer=tf.keras.optimizers.Adam(learning_rate=learning_rate),
                               model=kmodel)
    prefix = ckpt.write(output_prefix)

    keras_major = int(str(getattr(tf.keras, "__version__", "2")).split(".")[0])
    schema = ("model/_operations/K (Keras 3, restores in TF >= 2.16)"
              if keras_major >= 3 else
              "model/layer_with_weights-K (Keras 2, restores in TF <= 2.15)")
    print(f"Checkpoint schema: {schema} — a reference deployment on the other Keras "
          "major will silently restore nothing (expect_partial); re-export under its "
          "TF version if so.")
    return prefix
