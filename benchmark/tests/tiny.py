"""A cell cut to a size the CPU runs in a second: base width 16; for
serving, slides of 256^2 in tiles of 128 with a halo of 16 and a pool of
2; for training, a pool of 8 pairs of 64^2 in batches of 4."""

import os
import time

import torch

from harness import manifest, runner

ROOT = os.path.dirname(manifest.BENCH_DIR)


def cell(name: str) -> manifest.Cell:
    return shrink(manifest.load_cell(name, ROOT))


def shrink(c: manifest.Cell) -> manifest.Cell:
    c.config["base_features"] = 16
    if c.traffic["driver"] == "train_steps":
        c.traffic.update(size=64, pool=8, batch=4, warm_steps=1)
        return c
    c.traffic.update(size=256, tile=128, radius=16, pool=2, batch=4, balance_side=64,
                     check_sample=2, warm_passes=1, reference_batch=2)
    if "calibration" in c.config.get("serve", {}):
        c.config["serve"]["calibration"]["max_dim"] = 64
    return c


def run(c: manifest.Cell, seed: int = 2 ** 31 + 7, seconds: float = 0.5) -> dict:
    return runner.run_cell(c, seed=seed, seconds=seconds, trace=False,
                           device=torch.device("cpu"), process_start=time.perf_counter())
