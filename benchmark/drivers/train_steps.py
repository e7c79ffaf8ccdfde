"""Steady raw train steps of the program, from a pool on the device.

Set-up makes the weights (``harness/weights.py``) and a pool of image and
mask pairs (``traffic/<generator>.py``) from the seed, builds one train
state of the program (the U-Net in the configuration's dtype loaded with
the weights, ``KerasAdam``, and its two generators on the device, seeded
from the seed) and the program's raw step
(``tpuseg_torch.train.steps.make_raw_steps``: augmentation on the card
from the state's generator, z-score, one-hot, forward, loss, backward,
Adam). It drives that state through its first ``checked_steps`` steps on
batches that all differ, reading each step's loss, the first gradient of
each leaf (from Adam's first moment after one step) and each leaf's
change after the last, then ``warm_steps`` more. The window steps the same
state for ``seconds``, batch after batch of the pool in turn, and ends in
a synchronize.

Once the window has closed and the program's state is freed, the plain
reference (``reference/train.py``) trains from the same weights on the
same batches with generators seeded alike, in float32 and, as the
yardstick, in the configuration's precision, and the program is compared
with both (``reference/train.py::compare``).
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from harness import checks as checks_lib
from harness import weights as weights_lib
from harness.common import child_seeds, make_pool, sync
from reference import train as ref_train

BETA1 = 0.9


def batch(pool, i: int, size: int):
    images, masks = pool
    n = images.shape[0] // size
    s = (i % n) * size
    return images[s:s + size], masks[s:s + size]


def build_step(cfg: dict, traffic: dict, weights: Dict[str, torch.Tensor], seeds, device):
    """The program's train state and raw step for the configuration."""
    from tpuseg_torch.aug.device import DeviceAugmentParams
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.train.steps import KerasAdam, TrainState, make_raw_steps

    train = cfg["train"]
    if device.type == "cuda":
        from tpuseg_torch.kernels import build

        build.build(train["kernels"])
    with torch.device(device):
        model = UNet(cfg["num_classes"], cfg["num_channels"], cfg["base_features"],
                     dtype=train["dtype"])
    missing, unexpected = model.load_state_dict(weights, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise RuntimeError(f"weights do not fit the model: missing {missing}, "
                           f"unexpected {unexpected}")
    aug_seed, drop_seed = seeds
    state = TrainState(model=model,
                       optimizer=KerasAdam(model.parameters(), lr=train["learning_rate"]),
                       aug_generator=torch.Generator(device=device).manual_seed(aug_seed),
                       dropout_generator=torch.Generator(device=device).manual_seed(drop_seed))
    step, _ = make_raw_steps(cfg["num_classes"], DeviceAugmentParams(**traffic["augment"]),
                             augment=train["augment"])
    return state, step


def readings(state, step, pool, traffic: dict, weights: Dict[str, torch.Tensor]) -> Dict:
    """Drive the state through its first ``checked_steps`` steps: the
    losses, the first gradient of each leaf (Adam's first moment after one
    step over ``1 - beta1``, kept in host memory) and its norm, and the norm
    of each leaf's change after the last step."""
    names = dict((p, n) for n, p in state.model.named_parameters())
    out = {"losses": []}
    for t in range(traffic["checked_steps"]):
        metrics = step(state, *batch(pool, t, traffic["batch"]))
        out["losses"].append(float(metrics["loss"]))
        if t == 0:
            out["grads"] = {names[p]: (s["exp_avg"] / (1 - BETA1)).detach().cpu()
                            for p, s in state.optimizer.state.items()}
            out["grad_norms"] = {k: float(g.norm()) for k, g in out["grads"].items()}
    out["change_norms"] = {n: float((p.detach() - weights[n]).norm())
                           for n, p in state.model.named_parameters()}
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, process_start: float,
        tmpdir: str) -> dict:
    from harness import trace as trace_lib

    cfg, traffic = cell.config, cell.traffic
    started = time.perf_counter() - process_start
    phases, t = {"process_start": started}, time.perf_counter()

    def done(name):
        nonlocal t
        sync(device)
        phases[name] = time.perf_counter() - t
        t = time.perf_counter()

    s_weights, s_pool, s_aug, s_drop = child_seeds(seed, 4)
    weights = weights_lib.make(cfg, s_weights, device)
    done("weights")
    pool = make_pool(traffic, s_pool, device)
    done("pool")
    state, step = build_step(cfg, traffic, weights, (s_aug, s_drop), device)
    done("train_state")
    got = readings(state, step, pool, traffic, weights)
    for i in range(traffic["warm_steps"]):
        step(state, *batch(pool, traffic["checked_steps"] + i, traffic["batch"]))
    done("first_steps")
    if device.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    n = traffic["checked_steps"] + traffic["warm_steps"]
    first = n
    summary, stretch = None, (0, 0.0, 0.0)
    sync(device)
    t_start, c_start = time.perf_counter(), time.process_time()
    setup_s = t_start - process_start
    deadline = t_start + seconds

    def one():
        nonlocal n
        step(state, *batch(pool, n, traffic["batch"]))
        n += 1

    while time.perf_counter() < deadline:
        if trace and summary is None and time.perf_counter() >= t_start + seconds / 2:
            n0, t0, c0 = n, time.perf_counter(), time.process_time()
            summary = trace_lib.profile_stretch(one, traffic["trace_items"], tmpdir)
            stretch = (n - n0, time.perf_counter() - t0, time.process_time() - c0)
            continue
        one()
    sync(device)
    t_end, c_end = time.perf_counter(), time.process_time()
    window = t_end - t_start
    steps = n - first
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del state, step
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    common = ([batch(pool, i, traffic["batch"]) for i in range(traffic["checked_steps"])],
              s_aug, s_drop, cfg["train"]["learning_rate"], traffic["augment"],
              cfg["num_classes"], cfg["levels"], device)
    ref = ref_train.run_steps(weights, *common)
    stick = ref_train.run_steps(weights, *common, dtype=ref_train.DTYPES[
        checks_lib.spec(cell.name)["yardstick"]["dtype"]])
    numbers = ref_train.compare(got, ref, yardstick=stick)
    worst = numbers.pop("worst_leaf")
    checks = checks_lib.compare(cell.name, numbers)
    images = steps * traffic["batch"]
    outside = steps - stretch[0]
    ctx = {"kind": "train", "config": cell.config, "traffic": traffic, "trace": summary,
           "window": {"items": steps, "seconds": window, "items_outside": outside,
                      "seconds_outside": window - stretch[1],
                      "cpu_outside": (c_end - c_start) - stretch[2]},
           "images_per_step": traffic["batch"], "peak_window_bytes": peak}
    return {"end_to_end": {"train_img_s": images / window, "setup_s": setup_s},
            "ctx": ctx, "trace": summary, "checks": checks,
            "attempted": steps, "failed": 0,
            "memory_peak_bytes": max(peak, setup_peak) if device.type == "cuda" else 0,
            "notes": {"setup_phases": phases, "losses": got["losses"],
                      "reference_losses": ref["losses"],
                      "worst_leaf": worst,
                      "uncompared": {k: v for k, v in numbers.items() if k not in checks}}}
