"""tpuseg_torch — the PyTorch/CUDA port of ``tpuseg`` for NVIDIA Hopper.

A second package beside ``tpuseg`` (the JAX reference, which stays as it
is). Module names follow ``tpuseg`` so each counterpart is easy to find:

- ``tpuseg_torch.models``  — the U-Net as an ``nn.Module``
- ``tpuseg_torch.infer``   — ERF probe, halo-tiled and streamed whole-slide
  inference, int8 serving, and the blocked head+argmax CUDA kernel
  (``infer/head_kernel.py``)
- ``tpuseg_torch.data``    — record stores (tsrstore, reference LMDB), the
  database builder, the training readers
- ``tpuseg_torch.aug``, ``tpuseg_torch.train`` — augmentation and training
- ``tpuseg_torch.ops``     — losses, metrics, and the row-shear CUDA kernel
  (``ops/warp.py``)
- ``tpuseg_torch.kernels`` — builds the CUDA sources in ``csrc/``
- ``tpuseg_torch.utils``   — checkpoints, the flax->torch weight bridge,
  image and BigTIFF IO
- ``tpuseg_torch.cli``     — ``python -m tpuseg_torch.cli.{build_lmdb,
  convert_db,train,inference,evaluate}``

The port imports ``torch``, numpy and scipy, never ``jax`` and nothing of
``tpuseg``: what it needs of ``tpuseg``'s numpy-only modules it copies.
Public functions keep the JAX package's layout (NHWC float batches in,
int32 ``(B, H, W)`` labels out).
"""

__version__ = "0.1.0"

SIZE_FACTOR = 16  # 4 pooling halvings; ref model.py:25
RADIUS = 96  # nearest x16 above U-Net paper's 92px context radius; ref model.py:26
