"""Programmatic launcher for the PyTorch/CUDA port (the counterpart of
launch_train.py, reference UNet/launch_train.py role): edit the constants,
run the file. Prefer the CLI (python -m tpuseg_torch.cli.train) for
scripted use. Trains on the card (``TrainConfig.device``, "cuda")."""

from tpuseg_torch.train.trainer import TrainConfig, train_model

train_database = "../data/train-HES.lmdb"
test_database = "../data/test-HES.lmdb"
output_dir = "../output"
batch_size = 4
number_classes = 2
learning_rate = 3e-4
test_every_n_steps = 1000
balance_classes = 0
use_augmentation = 1
early_stopping = 10
reader_count = 1

if __name__ == "__main__":
    train_model(TrainConfig(
        train_database=train_database,
        test_database=test_database,
        output_folder=output_dir,
        batch_size=batch_size,
        number_classes=number_classes,
        learning_rate=learning_rate,
        test_every_n_steps=test_every_n_steps,
        balance_classes=bool(balance_classes),
        use_augmentation=bool(use_augmentation),
        early_stopping_count=early_stopping,
        reader_count=reader_count,
    ))
