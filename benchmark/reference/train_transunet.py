"""The plain reference train step of TransUNet: float32 PyTorch, autograd,
Keras Adam.

:func:`run_steps` is ``reference/train.py::run_steps`` with the forward of
``reference/transunet.py`` in train mode: the same augmentation
(``reference/augment.py``, from a generator seeded as the program's), the
same loss (``reference/train.py::loss_fn``), the Keras Adam rule, and
dropout masks drawn from a generator seeded as the program's dropout
generator, in the program's order. It returns what
``reference/train.py::compare`` reads. ``fp8`` and ``dtype`` make it the
control and the yardstick, as ``reference/transunet.py`` describes. TF32
is off while it runs.

:func:`compare` gives the numbers that decide ``correct``:
``reference/train.py::compare``'s and ``grad_dev_decoder``.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from reference import augment, transunet
from reference import train as ref_train
from reference.train import ADAM_EPS, BETAS, loss_fn, trainable
from reference.unet import no_tf32

# the leaves of grad_dev_decoder, by name prefix
DECODER = ("decoder.", "head.")


def run_steps(weights: Dict[str, torch.Tensor], batches, aug_seed: int, drop_seed: int,
              lr: float, aug_params: Dict, num_classes: int, cfg: dict, device,
              fp8: bool = False, dtype: torch.dtype = torch.float32) -> Dict:
    """Train from ``weights`` on ``batches`` (raw images and masks), one step
    each: ``losses``, the first step's gradient of each leaf (``grads``) and
    its norm (``grad_norms``), and each leaf's change after the last step
    (``change_norms``)."""
    names = trainable(weights)
    leaves = {k: weights[k].detach().clone().float().requires_grad_(True) for k in names}
    params = dict(weights, **leaves)
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    g_aug = torch.Generator(device=device).manual_seed(aug_seed)
    g_drop = torch.Generator(device=device).manual_seed(drop_seed)
    b1, b2 = BETAS
    out = {"losses": []}
    with no_tf32():
        for t, (img, msk) in enumerate(batches, start=1):
            x, y = augment.augment(g_aug, img, msk, aug_params, num_classes)
            logits = transunet.forward(params, x, cfg, train=True, g_drop=g_drop, fp8=fp8,
                                       dtype=dtype)
            loss = loss_fn(logits, y)
            grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
            out["losses"].append(float(loss.detach()))
            if t == 1:
                out["grads"] = {k: g.detach().clone() for k, g in grads.items()}
                out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
            scale = (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            with torch.no_grad():
                for k in names:
                    m[k].mul_(b1).add_(grads[k] * (1 - b1))
                    v2[k].mul_(b2).add_(grads[k] * grads[k] * (1 - b2))
                    leaves[k].add_(-lr * m[k] * scale / (torch.sqrt(v2[k]) + ADAM_EPS))
            del grads, loss, logits, x, y
    out["change_norms"] = {k: float((leaves[k].detach() - weights[k]).norm()) for k in names}
    return out


def compare(got: Dict, ref: Dict, yardstick: Dict) -> Dict[str, float]:
    """``reference/train.py::compare``'s numbers and ``grad_dev_decoder``:
    its ``grad_dev`` over the decoder's and the head's leaves alone, the
    median over them of the norm of the difference between the program's
    first gradient and the yardstick's, over the yardstick's own from the
    reference's. At the seeded start the first gradient of every leaf
    before the decoder (the ResNet, the embeddings, the ViT) moves by 50
    to 120% of its norm when the weights alone are rounded to bf16 and
    the rest is computed in float32, so there a computation in bf16 and
    one in fp8 part from float32 alike; the decoder's and the head's move
    by 1 to 4%, and there fp8 departs ten times as far as bf16."""
    out = ref_train.compare(got, ref, yardstick=yardstick)

    def err(a, b, k):
        return float((a["grads"][k].float().cpu() - b["grads"][k].float().cpu()).norm())

    ratios = []
    for k in ref["grads"]:
        own = err(yardstick, ref, k) if k.startswith(DECODER) else 0.0
        if own > 0:
            ratios.append(err(got, yardstick, k) / own)
    out["grad_dev_decoder"] = statistics.median_high(ratios) if ratios else float("inf")
    return out
