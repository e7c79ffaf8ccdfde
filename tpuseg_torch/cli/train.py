"""CLI: train a U-Net model, on the card.

    python -m tpuseg_torch.cli.train --train_database D --test_database T \
        --output_dir O [--device cuda|cpu]

Flags mirror ``tpuseg.cli.train`` (reference ``UNet/train.py:211-234``:
names, defaults, help) plus ``--device`` and ``--base_features`` (the
width, as the inference CLI takes it). Flags that wait for later slices
are accepted with their single-GPU defaults and rejected with a message
(``NotImplementedError``) otherwise: ``--multihost``, ``--spatial``,
``--shard_optimizer`` (multi-GPU) and ``--profile_steps`` (tooling).
"""

import argparse

from tpuseg_torch.train.trainer import TrainConfig, train_model


def main(argv=None):
    """Parse ``argv``, train, and return the ``TrainResult``."""
    parser = argparse.ArgumentParser(prog="train_unet",
                                     description="Script which trains a unet model")
    parser.add_argument("--train_database", dest="train_database_filepath", type=str,
                        help="database to use for training (Required)", required=True)
    parser.add_argument("--test_database", dest="test_database_filepath", type=str,
                        help="database to use for testing (Required)", required=True)
    parser.add_argument("--output_dir", dest="output_folder", type=str,
                        help="Folder where outputs will be saved (Required)", required=True)
    parser.add_argument("--batch_size", dest="batch_size", type=int,
                        help="training batch size", default=4)
    parser.add_argument("--number_classes", dest="number_classes", type=int, default=2)
    parser.add_argument("--learning_rate", dest="learning_rate", type=float, default=3e-4)
    parser.add_argument("--test_every_n_steps", dest="test_every_n_steps", type=int,
                        help="number of gradient update steps to take between test epochs",
                        default=1000)
    parser.add_argument("--balance_classes", dest="balance_classes", type=int,
                        help="whether to balance classes [0 = false, 1 = true]", default=0)
    parser.add_argument("--use_augmentation", dest="use_augmentation", type=int,
                        help="whether to use data augmentation [0 = false, 1 = true]",
                        default=1)
    parser.add_argument("--early_stopping", dest="early_stopping_count", type=int,
                        help="Perform early stopping when the test loss does not improve "
                             "for N epochs.", default=10)
    parser.add_argument("--reader_count", dest="reader_count", type=int,
                        help="how many processes to use for disk I/O and augmentation "
                             "per GPU", default=1)
    parser.add_argument("--device", dest="device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="where to train; cuda (default) raises when no card "
                             "is available instead of running on the CPU")
    parser.add_argument("--base_features", dest="base_features", type=int, default=64,
                        help="first-level feature depth of the U-Net (the reference "
                             "width, model.py:20, by default); the inference CLI "
                             "takes the same flag")
    # --- tpuseg extensions ---
    parser.add_argument("--seed", dest="seed", type=int, default=None,
                        help="seed for init/sampling/augmentation (tpuseg extension)")
    parser.add_argument("--max_epochs", dest="max_epochs", type=int, default=None,
                        help="hard cap on TOTAL epochs, counting any resumed "
                             "test-loss history (a resumed run gets at least "
                             "one new epoch) (tpuseg extension)")
    parser.add_argument("--dtype", dest="dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="on-device compute dtype (tpuseg extension)")
    parser.add_argument("--label_smoothing", dest="label_smoothing", type=float,
                        default=0.0, help="CCE label smoothing (tpuseg extension)")
    parser.add_argument("--device_augmentation", dest="device_augmentation", type=int,
                        default=1,
                        help="run augmentation on the device [1] or on host CPUs "
                             "like the reference [0] (tpuseg extension)")
    parser.add_argument("--resume_checkpoint", dest="resume_checkpoint", type=str,
                        default=None,
                        help="training checkpoint (<output>/checkpoint/ckpt) to "
                             "resume the full training state from (tpuseg extension)")
    parser.add_argument("--shard_optimizer", dest="shard_optimizer", type=int, default=0,
                        help="ZeRO-1 weight-update sharding over GPUs (not ported "
                             "yet: raises when 1)")
    parser.add_argument("--spatial", dest="spatial", type=int, default=1,
                        help="spatial partitioning over groups of N GPUs (not "
                             "ported yet: raises when not 1)")
    parser.add_argument("--profile_steps", dest="profile_steps", type=int, default=0,
                        help="device trace of the first N steady-state steps "
                             "(not ported yet: raises when not 0)")
    parser.add_argument("--batch_echo", dest="batch_echo", type=int, default=1,
                        help="data echoing (arXiv:1907.05550): optimizer steps per "
                             "fetched batch; with device augmentation each echo "
                             "re-augments on device. For IO-bound deployments "
                             "(tpuseg extension)")
    parser.add_argument("--log_every_n_steps", dest="log_every_n_steps", type=int, default=1,
                        help="read/print train metrics every N steps; metrics "
                             "accumulate on the card between reads and the window "
                             "mean is printed. 1 = reference-parity per-step prints "
                             "(tpuseg extension)")
    parser.add_argument("--multihost", dest="multihost", type=int, default=0,
                        help="multi-host training (not ported yet: raises when 1)")
    # augmentation severities: hard-coded class attributes in the reference
    # (imagereader.py:79-85, README.md:176-189); promoted to flags here
    parser.add_argument("--rotation_flag", type=int, default=1)
    parser.add_argument("--reflection_flag", type=int, default=1)
    parser.add_argument("--jitter_severity", type=float, default=0.1,
                        help="jitter as a fraction of the FOV")
    parser.add_argument("--noise_severity", type=float, default=0.02,
                        help="noise as a fraction of the image dynamic range")
    parser.add_argument("--scale_severity", type=float, default=0.1)
    parser.add_argument("--blur_max_sigma", type=float, default=2.0, help="pixels")
    parser.add_argument("--intensity_severity", type=float, default=0.0,
                        help="additive intensity shift as a fraction of dynamic range")
    args = parser.parse_args(argv)

    if args.multihost:
        raise NotImplementedError(
            "--multihost is not ported yet (it comes with the multi-GPU slice)")

    from tpuseg_torch.data.reader import AugmentParams

    augment_params = AugmentParams(
        reflection_flag=bool(args.reflection_flag),
        rotation_flag=bool(args.rotation_flag),
        jitter_augmentation_severity=args.jitter_severity,
        noise_augmentation_severity=args.noise_severity,
        scale_augmentation_severity=args.scale_severity,
        blur_max_sigma=args.blur_max_sigma,
        intensity_augmentation_severity=args.intensity_severity or None,
    )

    cfg = TrainConfig(
        train_database=args.train_database_filepath,
        test_database=args.test_database_filepath,
        output_folder=args.output_folder,
        batch_size=args.batch_size,
        number_classes=args.number_classes,
        learning_rate=args.learning_rate,
        test_every_n_steps=args.test_every_n_steps,
        balance_classes=bool(args.balance_classes),
        use_augmentation=bool(args.use_augmentation),
        early_stopping_count=args.early_stopping_count,
        reader_count=args.reader_count,
        label_smoothing=args.label_smoothing,
        seed=args.seed,
        max_epochs=args.max_epochs,
        dtype=args.dtype,
        base_features=args.base_features,
        device_augment=bool(args.device_augmentation),
        resume_checkpoint=args.resume_checkpoint,
        shard_optimizer=bool(args.shard_optimizer),
        spatial_partitions=args.spatial,
        profile_steps=args.profile_steps,
        log_every_n_steps=args.log_every_n_steps,
        batch_echo=args.batch_echo,
        augment_params=augment_params,
        device=args.device,
    )
    return train_model(cfg)


if __name__ == "__main__":
    main()
