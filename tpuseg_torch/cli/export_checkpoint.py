"""CLI: convert a port checkpoint to a reference TensorFlow checkpoint.

    python -m tpuseg_torch.cli.export_checkpoint --checkpoint_filepath C --output_prefix P

Counterpart of ``tpuseg.cli.export_checkpoint`` (the same flags) and the
inverse of ``tpuseg_torch.cli.import_checkpoint``: the model is written as
the reference's ``tf.train.Checkpoint(optimizer, model)`` (train.py:96),
ready for the reference's ``inference.py`` (model.py:81-83). Needs
TensorFlow. The geometry comes from the checkpoint; ``--number_classes``,
``--number_channels`` and ``--base_features``, when given, must agree
with it.
"""

import argparse


def main(argv=None) -> str:
    """Parse ``argv``, export, and return the written prefix."""
    parser = argparse.ArgumentParser(
        prog="export_tf_checkpoint",
        description="Convert a tpuseg_torch checkpoint into a reference "
                    "tf.train.Checkpoint (UNet/train.py:96)")
    parser.add_argument("--checkpoint_filepath", dest="checkpoint_filepath", type=str,
                        required=True, help="tpuseg_torch checkpoint file (Required)")
    parser.add_argument("--output_prefix", dest="output_prefix", type=str, required=True,
                        help="TF checkpoint prefix to write, e.g. "
                             ".../checkpoint/ckpt (Required)")
    parser.add_argument("--number_classes", dest="number_classes", type=int, default=None,
                        help="checked against the checkpoint's own geometry")
    parser.add_argument("--number_channels", dest="number_channels", type=int, default=None,
                        help="checked against the checkpoint's own geometry")
    parser.add_argument("--base_features", dest="base_features", type=int, default=None,
                        help="first-level feature depth; checked against the checkpoint")
    parser.add_argument("--learning_rate", dest="learning_rate", type=float, default=3e-4,
                        help="learning rate recorded in the emitted Adam optimizer")
    args = parser.parse_args(argv)

    from tpuseg_torch.utils.tf_export import export_reference_checkpoint

    prefix = export_reference_checkpoint(
        args.checkpoint_filepath, args.output_prefix, args.number_classes,
        args.number_channels, args.base_features, args.learning_rate)
    print(f"Reference TF checkpoint written to {prefix}")
    print("Use it as the reference's --checkpoint_filepath for inference.")
    return prefix


if __name__ == "__main__":
    main()
