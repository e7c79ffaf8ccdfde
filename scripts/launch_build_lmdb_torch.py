"""Programmatic launcher for the PyTorch/CUDA port's data tools (the
counterpart of launch_build_lmdb.py, reference UNet/launch_build_lmdb.py
role; host only)."""

from tpuseg_torch.data.build_db import build_databases

image_folder = "../data/images"
mask_folder = "../data/masks"
output_folder = "../data"
dataset_name = "HES"
train_fraction = 0.8
image_format = "tif"
use_tiling = 0
tile_size = 512

if __name__ == "__main__":
    build_databases(
        image_folder=image_folder,
        mask_folder=mask_folder,
        output_folder=output_folder,
        dataset_name=dataset_name,
        train_fraction=train_fraction,
        image_format=image_format,
        use_tiling=bool(use_tiling),
        tile_size=tile_size,
    )
