"""CLI: convert a reference TensorFlow checkpoint to a port checkpoint.

    python -m tpuseg_torch.cli.import_checkpoint --tf_checkpoint P --output_folder O

Counterpart of ``tpuseg.cli.import_checkpoint`` (the same flags). The
reference trains with TF and saves ``tf.train.Checkpoint(optimizer,
model)`` (train.py:96, 181-184); this reads it without TensorFlow
(``tpuseg_torch.utils.tf_bundle``) and writes ``O/ckpt``, a training
checkpoint that ``tpuseg_torch.cli.inference`` serves and ``cli.train
--resume_checkpoint`` resumes.
"""

import argparse
import os


def main(argv=None) -> dict:
    """Parse ``argv``, import, and return the geometry."""
    parser = argparse.ArgumentParser(
        prog="import_tf_checkpoint",
        description="Convert a reference tf.train.Checkpoint (UNet/model.py:81-83) "
                    "into a tpuseg_torch checkpoint")
    parser.add_argument("--tf_checkpoint", dest="tf_checkpoint", type=str, required=True,
                        help="TF checkpoint prefix (e.g. .../checkpoint/ckpt) or the "
                             "directory containing it (Required)")
    parser.add_argument("--output_folder", dest="output_folder", type=str, required=True,
                        help="directory to write the checkpoint 'ckpt' into (Required)")
    parser.add_argument("--learning_rate", dest="learning_rate", type=float, default=3e-4,
                        help="learning rate recorded in the emitted train state "
                             "(only relevant if training is resumed from it)")
    args = parser.parse_args(argv)

    from tpuseg_torch.utils.tf_import import import_reference_checkpoint

    out = os.path.join(args.output_folder, "ckpt")
    geometry = import_reference_checkpoint(args.tf_checkpoint, out, args.learning_rate)
    print(f"Imported reference checkpoint: {geometry}")
    print(f"tpuseg_torch checkpoint written to {out}")
    bf = geometry["base_features"]
    bf_flag = f"--base_features {bf} " if bf != 64 else ""
    print("Serve it with: python -m tpuseg_torch.cli.inference "
          f"--checkpoint_filepath {out} "
          f"--number_classes {geometry['number_classes']} "
          f"--number_channels {geometry['number_channels']} {bf_flag}...")
    return geometry


if __name__ == "__main__":
    main()
