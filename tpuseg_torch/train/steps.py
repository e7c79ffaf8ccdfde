"""Train and eval steps, with Adam under the Keras update rule.

Counterpart of ``tpuseg/train/steps.py``. The reference's per-replica
``train_step`` (model.py:204-228) is forward, CCE loss, backward, Adam and
the metrics; here it runs eagerly on the model's device. Where JAX donates
the train state to the next step, the port updates it in place: the
parameters, the Adam moments and the BatchNorm running statistics. A step
returns its metrics as device scalars, so the trainer can sum a window of
them without waiting for the card.

The learning rate lives in the optimizer's param group, so the warmup
changes it without rebuilding anything.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from tpuseg_torch.models.unet import UNet, init_unet
from tpuseg_torch.ops.losses import categorical_accuracy, cce_from_logits, reference_scalar_loss


class KerasAdam(torch.optim.Optimizer):
    """Adam with TF/Keras update semantics (optimizer_v2 Adam, the optimizer
    the reference builds at model.py:79):

        lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)
        var -= lr_t * m_t / (sqrt(v_t) + eps)

    so eps (1e-7) is added to the UNCORRECTED sqrt(v_t). ``torch.optim.Adam``
    adds it to the bias-corrected sqrt(v_hat), a different update early in
    training. The arithmetic follows ``tpuseg.train.steps.keras_adam`` op
    for op in float32; the step count lives in the param group (saved with
    the optimizer's state dict), and the bias correction is computed on the
    host in float32, so a step never waits for the card.
    """

    def __init__(self, params, lr: float = 0.0, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, step=0))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            group["step"] += 1
            grads, ms, vs = [], [], []
            for p in params:
                state = self.state[p]
                if not state:
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                grads.append(p.grad)
                ms.append(state["exp_avg"])
                vs.append(state["exp_avg_sq"])
            # mu = b1*mu + (1-b1)*g ; nu = b2*nu + (1-b2)*g^2
            torch._foreach_mul_(ms, b1)
            torch._foreach_add_(ms, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(vs, b2)
            torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            c = np.float32(group["step"])
            scale = float(np.sqrt(np.float32(1) - np.float32(b2) ** c)
                          / (np.float32(1) - np.float32(b1) ** c))
            upd = torch._foreach_div(torch._foreach_mul(ms, scale),
                                     torch._foreach_add(torch._foreach_sqrt(vs), group["eps"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


@dataclass
class TrainState:
    """What one training run carries from step to step: the model (its
    parameters and BatchNorm statistics), the optimizer (moments, step
    count, learning rate), and the two device generators (augmentation
    draws and dropout masks)."""

    model: UNet
    optimizer: KerasAdam
    aug_generator: torch.Generator
    dropout_generator: torch.Generator
    step: int = 0

    @property
    def lr(self) -> float:
        return self.optimizer.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)


def _child_seeds(seed: int, n: int):
    return [int(s.generate_state(1)[0]) for s in np.random.SeedSequence(seed).spawn(n)]


def create_train_state(model: UNet, seed: int, learning_rate: float,
                       device) -> TrainState:
    """Keras-initialize ``model`` (weights from ``seed``), move it to
    ``device`` and pair it with a fresh optimizer and the two generators,
    all seeded from ``seed`` through independent child seeds."""
    device = torch.device(device)
    init_seed, aug_seed, drop_seed = _child_seeds(seed, 3)
    init_unet(model, torch.Generator().manual_seed(init_seed))
    model.to(device)
    return TrainState(
        model=model,
        optimizer=KerasAdam(model.parameters(), lr=learning_rate),
        aug_generator=torch.Generator(device=device).manual_seed(aug_seed),
        dropout_generator=torch.Generator(device=device).manual_seed(drop_seed),
    )


def train_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
               label_smoothing: float = 0.0) -> Dict[str, torch.Tensor]:
    """One optimization step, in place on ``state``.

    images: [N,H,W,C] float32 (already normalized); labels: [N,H,W,classes]
    one-hot. Loss scaling follows model.py:211-215 with global batch = N.
    Returns device scalars ``loss`` and ``accuracy`` (of the pre-update
    forward, as the JAX step does)."""
    model = state.model
    model.train()
    logits = model(images, generator=state.dropout_generator)
    per_pixel = cce_from_logits(logits, labels, label_smoothing)
    loss = reference_scalar_loss(per_pixel, images.shape[0])
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    state.optimizer.step()
    state.step += 1
    with torch.no_grad():
        acc = categorical_accuracy(logits, labels)
    return {"loss": loss.detach(), "accuracy": acc}


@torch.no_grad()
def eval_step(state: TrainState, images: torch.Tensor, labels: torch.Tensor,
              label_smoothing: float = 0.0) -> Dict[str, torch.Tensor]:
    """model.py:237-250: forward in inference mode, same loss scaling."""
    model = state.model
    model.eval()
    logits = model(images)
    per_pixel = cce_from_logits(logits, labels, label_smoothing)
    loss = reference_scalar_loss(per_pixel, images.shape[0])
    return {"loss": loss, "accuracy": categorical_accuracy(logits, labels)}


StepFn = Callable[[TrainState, torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]


def make_steps(label_smoothing: float = 0.0) -> Tuple[StepFn, StepFn]:
    """(train_step, eval_step) over host-preprocessed batches: float32
    z-scored images and one-hot integer labels."""
    def tstep(state, images, labels):
        return train_step(state, images, labels.float(), label_smoothing)

    def estep(state, images, labels):
        return eval_step(state, images, labels.float(), label_smoothing)

    return tstep, estep


def make_raw_steps(num_classes: int, aug_params=None, augment: bool = True,
                   label_smoothing: float = 0.0) -> Tuple[StepFn, StepFn]:
    """(train_step, eval_step) over RAW uint batches: augmentation (from the
    state's augmentation generator), z-score and one-hot run on the batch's
    device before forward/backward/Adam — the composition of
    ``tpuseg.train.steps.compose_raw_steps``. Eval never augments and draws
    nothing."""
    from tpuseg_torch.aug.device import DeviceAugmentParams, augment_and_preprocess_batch

    if aug_params is None:
        aug_params = DeviceAugmentParams()

    def tstep(state: TrainState, raw_images, raw_masks):
        images, labels = augment_and_preprocess_batch(
            state.aug_generator, raw_images, raw_masks, aug_params, num_classes, augment)
        return train_step(state, images, labels, label_smoothing)

    def estep(state: TrainState, raw_images, raw_masks):
        images, labels = augment_and_preprocess_batch(
            None, raw_images, raw_masks, aug_params, num_classes, augment=False)
        return eval_step(state, images, labels, label_smoothing)

    return tstep, estep

