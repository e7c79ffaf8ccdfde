"""CLI: segment a folder of images with a trained checkpoint, on the card.

Flags mirror ``tpuseg.cli.inference`` (reference ``UNet/inference.py:
231-241``) plus ``--device``. ``--streaming`` segments tiled-BigTIFF slides
larger than host RAM as a rolling strip through the device. Each tile group
shards over every visible GPU (``--no_data_parallel``: one); ``--multihost
1`` under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
tpuseg_torch.cli.inference --multihost 1 ...``) joins a gloo process group
and stripes the sorted folder over the processes, each on its own GPU.
"""

import argparse

from tpuseg_torch.infer.runner import QUANTIZE_MODES, InferenceConfig, inference


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="inference",
        description="Script to inference (segment) a folder of images with the "
                    "selected unet model")
    parser.add_argument("--checkpoint_filepath", dest="checkpoint_filepath", type=str,
                        help="Checkpoint filepath to the model to use (written "
                             "by tpuseg_torch.utils.checkpoint.save_model)",
                        required=True)
    parser.add_argument("--image_folder", dest="image_folder", type=str,
                        help="filepath to the folder containing tif images to inference "
                             "(Required)", required=True)
    parser.add_argument("--output_folder", dest="output_folder", type=str, required=True)
    parser.add_argument("--number_classes", dest="number_classes", type=int, required=True)
    parser.add_argument("--number_channels", dest="number_channels", type=int, required=True)
    parser.add_argument("--image_format", dest="image_format", type=str,
                        help="format (extension) of the input images. E.g {tif, jpg, png)",
                        default="tif")
    parser.add_argument("--device", dest="device", type=str, default="cuda",
                        help="where to run: cuda (default; every visible GPU, or "
                             "the process's own under torchrun), cuda:N (that GPU "
                             "alone) or cpu; cuda raises when no card is available "
                             "instead of running on the CPU")
    parser.add_argument("--tile_size", dest="tile_size", type=int, default=1024,
                        help="tile size for large-image tiling")
    parser.add_argument("--batch_size", dest="batch_size", type=int, default=8,
                        help="tiles (or small images) per forward")
    parser.add_argument("--radius", dest="radius", type=int, default=None,
                        help="halo radius override; default measures the ERF")
    parser.add_argument("--dtype", dest="dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="compute dtype of the fp model")
    parser.add_argument("--base_features", dest="base_features", type=int, default=64,
                        help="first-level feature depth the checkpoint was built with")
    parser.add_argument("--no_data_parallel", dest="data_parallel", action="store_false",
                        help="run on one card even when several are visible "
                             "instead of sharding each tile group over them")
    parser.add_argument("--no_read_ahead", dest="read_ahead", action="store_false",
                        help="read images synchronously instead of prefetching the "
                             "next one (halves peak host memory)")
    parser.add_argument("--auto_tile", dest="auto_tile", action="store_true",
                        help="choose the tile size per image to minimize computed "
                             "pixels instead of the fixed --tile_size")
    parser.add_argument("--streaming", dest="streaming", action="store_true",
                        help="stream tiled-BigTIFF inputs as a rolling strip of "
                             "rows (images larger than host RAM); masks are "
                             "written incrementally as tiled BigTIFF")
    parser.add_argument("--quantize", dest="quantize", type=str, default="none",
                        choices=list(QUANTIZE_MODES),
                        help="int8: post-training-quantized serving path "
                             "calibrated on --calibration_images inputs; "
                             "int8_blocked additionally space-to-depth-blocks "
                             "the C=64 edge stages and runs the head through "
                             "the CUDA head+argmax kernel; int8_auto serves "
                             "tiled images blocked and small batches dense")
    parser.add_argument("--calibration_images", dest="calibration_images",
                        type=int, default=4,
                        help="inputs used for int8 activation-range calibration "
                             "(a deterministic evenly-spaced sample of the "
                             "sorted folder)")
    parser.add_argument("--calibration_in", dest="calibration_in",
                        type=str, default=None,
                        help="load persisted int8 calibration scales (JSON "
                             "written by --calibration_out, by this package or "
                             "by tpuseg) and skip calibration")
    parser.add_argument("--calibration_out", dest="calibration_out",
                        type=str, default=None,
                        help="write the calibrated int8 activation scales as JSON")
    parser.add_argument("--calibration_percentile", dest="calibration_percentile",
                        type=float, default=99.9,
                        help="|activation| percentile for the int8 clip range "
                             "(100 = exact max)")
    parser.add_argument("--seed", dest="seed", type=int, default=None,
                        help="seed the ERF probe's noise image so the measured "
                             "halo radius is reproducible across runs")
    parser.add_argument("--multihost", dest="multihost", type=int, default=0,
                        help="join torchrun's process group (gloo: serving has no "
                             "device collectives) and stripe the sorted folder over "
                             "the processes")
    args = parser.parse_args(argv)

    cfg = InferenceConfig(
        checkpoint_filepath=args.checkpoint_filepath,
        image_folder=args.image_folder,
        output_folder=args.output_folder,
        number_classes=args.number_classes,
        number_channels=args.number_channels,
        image_format=args.image_format,
        tile_size=args.tile_size,
        batch_size=args.batch_size,
        radius=args.radius,
        dtype=args.dtype,
        base_features=args.base_features,
        device=args.device,
        data_parallel=args.data_parallel,
        streaming=args.streaming,
        read_ahead=args.read_ahead,
        auto_tile=args.auto_tile,
        quantize=args.quantize,
        calibration_images=args.calibration_images,
        calibration_percentile=args.calibration_percentile,
        calibration_in=args.calibration_in,
        calibration_out=args.calibration_out,
        seed=args.seed,
    )

    if not args.multihost:
        return inference(cfg)
    from tpuseg_torch.parallel import distributed

    distributed.initialize_distributed(backend="gloo")
    try:
        return inference(cfg)
    finally:
        distributed.shutdown_distributed()


if __name__ == "__main__":
    main()
