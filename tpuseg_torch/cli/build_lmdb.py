"""CLI: build train/test databases from image+mask folders.

Flag names, defaults and help text follow the reference
``UNet/build_lmdb.py:238-248`` (as ``tpuseg.cli.build_lmdb`` does), so
existing invocations port unchanged; the storage engine underneath is
tsrstore (``tpuseg_torch.data.recordstore``). Runs on the host only.
"""

import argparse

from tpuseg_torch.data.build_db import build_databases


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="build_lmdb",
        description="Script which converts two folders of images and masks into a "
                    "pair of databases for training.")
    parser.add_argument("--image_folder", dest="image_folder", type=str,
                        help="filepath to the folder containing the images",
                        default="../data/images/")
    parser.add_argument("--mask_folder", dest="mask_folder", type=str,
                        help="filepath to the folder containing the masks",
                        default="../data/masks/")
    parser.add_argument("--output_folder", dest="output_folder", type=str,
                        help="filepath to the folder where the outputs will be placed",
                        default="../data/")
    parser.add_argument("--dataset_name", dest="dataset_name", type=str,
                        help="name of the dataset to be used in creating the lmdb files",
                        default="HES")
    parser.add_argument("--train_fraction", dest="train_fraction", type=float,
                        help="what fraction of the dataset to use for training (0.0, 1.0)",
                        default=0.8)
    parser.add_argument("--image_format", dest="image_format", type=str,
                        help="format (extension) of the input images. E.g {tif, jpg, png)",
                        default="tif")
    parser.add_argument("--use_tiling", dest="use_tiling", type=int,
                        help="Whether to shard the image into tiles [0 = False, 1 = True]",
                        default=0)
    parser.add_argument("--tile_size", dest="tile_size", type=int,
                        help="The size of the tiles to crop out of the source images, "
                             "striding across all available pixels in the source images",
                        default=512)
    parser.add_argument("--seed", dest="seed", type=int, default=None,
                        help="shuffle seed for a reproducible train/test split")
    args = parser.parse_args(argv)

    build_databases(
        image_folder=args.image_folder,
        mask_folder=args.mask_folder,
        output_folder=args.output_folder,
        dataset_name=args.dataset_name,
        train_fraction=args.train_fraction,
        image_format=args.image_format,
        use_tiling=bool(args.use_tiling),
        tile_size=args.tile_size,
        seed=args.seed,
    )
    return 0


if __name__ == "__main__":
    main()
