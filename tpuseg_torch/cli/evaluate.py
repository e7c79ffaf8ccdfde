"""CLI: score predicted masks against ground truth (mIoU / Dice / accuracy).

The port's counterpart of ``tpuseg.cli.evaluate``: host numpy over two
folders of masks with matching names; tiled-BigTIFF pairs stream tile by
tile (``tpuseg_torch.ops.metrics.evaluate_folder``).
"""

import argparse
import json

from tpuseg_torch.ops.metrics import evaluate_folder


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="evaluate",
        description="Score a folder of predicted masks against ground-truth masks "
                    "(matching filenames).")
    parser.add_argument("--pred_folder", dest="pred_folder", type=str, required=True,
                        help="folder of predicted masks (e.g. inference output)")
    parser.add_argument("--truth_folder", dest="truth_folder", type=str, required=True,
                        help="folder of ground-truth masks")
    parser.add_argument("--number_classes", dest="number_classes", type=int, required=True)
    args = parser.parse_args(argv)

    result = evaluate_folder(args.pred_folder, args.truth_folder, args.number_classes)
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    main()
