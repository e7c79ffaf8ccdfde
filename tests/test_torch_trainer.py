"""The port's training CLI (tpuseg_torch/cli/train.py -> train/trainer.py)
end to end on the CPU: base 4, 32^2 uint16 records with uint8 masks,
batch 2, two steps between test epochs, two epochs, with device
augmentation on and off. The run writes test_loss.csv and a training
checkpoint that tpuseg_torch.cli.inference serves; a resume continues the
step count and the test-loss history."""

import os

import numpy as np
import pytest
import torch

from tpuseg_torch.cli.inference import main as infer_main
from tpuseg_torch.cli.train import main as train_main
from tpuseg_torch.data.build_db import serialize_image_mask_pair
from tpuseg_torch.data.recordstore import RecordWriter
from tpuseg_torch.utils.checkpoint import load_model
from tpuseg_torch.utils.imagio import imread, imwrite
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def write_db(path, n, size, seed):
    """n records of learnable size^2 tiles: the mask thresholds a smooth
    field and the image is brighter where the mask is set."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    with RecordWriter(path) as w:
        for i in range(n):
            f = rng.uniform(0.1, 0.4, 2)
            msk = (np.sin(yy * f[0] + rng.uniform(0, 6)) * np.cos(xx * f[1]) > 0).astype(np.uint8)
            img = (1000.0 + 2000.0 * msk + rng.normal(0, 200, msk.shape)).clip(0, 65535)
            w.put(f"tile{i:04d}:0,1", serialize_image_mask_pair(img.astype(np.uint16), msk))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dbs")
    train, test = str(root / "train.lmdb"), str(root / "test.lmdb")
    write_db(train, 8, 32, 0)
    write_db(test, 4, 32, 1)
    return train, test


def _args(dbs, out, *extra):
    return ["--train_database", dbs[0], "--test_database", dbs[1], "--output_dir", out,
            "--batch_size", "2", "--test_every_n_steps", "2", "--max_epochs", "2",
            "--seed", "3", "--device", "cpu", *extra]


def _base(extra=()):
    # base 4: a narrow model the CPU trains in seconds (flag of this CLI)
    return ["--base_features", "4", *extra]


@pytest.mark.parametrize("device_aug", ["1", "0"])
def test_train_cli_writes_history_and_a_servable_checkpoint(dbs, tmp_path, device_aug):
    out = str(tmp_path / "out")
    res = train_main(_args(dbs, out, "--device_augmentation", device_aug, *_base()))
    with open(os.path.join(out, "test_loss.csv")) as f:
        rows = [float(line) for line in f if line.strip()]
    assert len(rows) == 2 and all(np.isfinite(rows))
    assert res.test_loss == rows and res.epochs_run == 2
    assert res.steps == 2 * 3  # size+1 steps per epoch (train.py:137)
    assert len(res.train_losses) == 6 and np.isfinite(res.train_losses).all()
    ckpt = os.path.join(out, "checkpoint", "ckpt")
    assert res.checkpoint_path == ckpt and os.path.exists(ckpt)

    model = load_model(ckpt, dtype="float32")
    assert model.config()["base_features"] == 4 and not model.training

    imgdir, maskdir = str(tmp_path / "imgs"), str(tmp_path / "masks")
    os.makedirs(imgdir)
    imwrite(os.path.join(imgdir, "a.tif"),
            np.random.default_rng(5).integers(0, 4000, (32, 32)).astype(np.uint16))
    written = infer_main(["--checkpoint_filepath", ckpt, "--image_folder", imgdir,
                          "--output_folder", maskdir, "--number_classes", "2",
                          "--number_channels", "1", "--base_features", "4",
                          "--device", "cpu", "--quantize", "none"])
    mask = imread(written[0])
    assert mask.shape == (32, 32) and set(np.unique(mask)) <= {0, 1}


def test_resume_continues_steps_and_history(dbs, tmp_path):
    out = str(tmp_path / "out")
    first = train_main(_args(dbs, out, *_base()))
    ckpt = os.path.join(out, "checkpoint", "ckpt")
    saved_step = torch.load(ckpt, weights_only=True)["step"]
    assert saved_step in (3, 6)
    res = train_main(_args(dbs, out, *_base(["--resume_checkpoint", ckpt,
                                             "--max_epochs", "3"])))
    assert res.steps == saved_step + 3  # one more epoch, no warmup epoch
    assert res.test_loss[:2] == first.test_loss and len(res.test_loss) == 3
    with open(os.path.join(out, "test_loss.csv")) as f:
        assert len([line for line in f if line.strip()]) == 3


@pytest.mark.parametrize("extra", [("--spatial", "2"),
                                   ("--shard_optimizer", "1", "--spatial", "2"),
                                   ("--spatial", "4"), ("--multihost", "1")])
def test_train_cli_rejects_what_is_not_ported(dbs, tmp_path, extra, monkeypatch):
    """A single process cannot form a spatial group of 2 or 4 GPUs (with
    ZeRO-1 or without); --multihost without torchrun's environment has no
    process group to join."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    exc = RuntimeError if "--multihost" in extra else ValueError
    with pytest.raises(exc, match="torchrun" if exc is RuntimeError else "spatial"):
        train_main(_args(dbs, str(tmp_path / "out"), *_base(extra)))


def test_train_cli_cuda_without_a_card_raises(dbs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present, so --device cuda runs")
    args = _args(dbs, str(tmp_path / "out"), *_base())
    args[args.index("cpu")] = "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(args)


def _small_state(seed=0):
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.train.steps import create_train_state

    return create_train_state(UNet(2, 1, 4, "float32"), seed, 1e-3, "cpu")


def _one_step(state, seed):
    from tpuseg_torch.train.steps import train_step

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (2, 16, 16, 1)).astype(np.float32))
    y = torch.nn.functional.one_hot((x[..., 0] > 0).long(), 2).float()
    return train_step(state, x, y)


def test_async_writer_snapshots_before_returning(tmp_path):
    """The optimizer updates in place, so the writer must copy the state
    before save() returns: a step taken right after does not leak in."""
    from tpuseg_torch.utils.checkpoint import AsyncCheckpointWriter

    state = _small_state()
    _one_step(state, 0)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    path = str(tmp_path / "checkpoint" / "ckpt")
    w = AsyncCheckpointWriter()
    w.save(path, state)
    _one_step(state, 1)  # mutates parameters, moments and BN stats in place
    w.wait()
    doc = torch.load(path, weights_only=True)
    assert doc["step"] == 1
    for k, v in want.items():
        assert torch.equal(doc["state_dict"][k], v), k
    assert not torch.equal(doc["state_dict"]["enc1a.conv.weight"],
                           state.model.state_dict()["enc1a.conv.weight"])


def test_restore_train_state_resumes_identically(tmp_path):
    """Save, restore into a fresh state, and take the same next step: the
    parameters, moments and dropout/augmentation generators carry over."""
    from tpuseg_torch.utils.checkpoint import AsyncCheckpointWriter, restore_train_state

    a = _small_state(0)
    _one_step(a, 0)
    a.lr = 5e-4
    path = str(tmp_path / "ckpt")
    writer = AsyncCheckpointWriter()
    writer.save(path, a)
    writer.wait()
    b = restore_train_state(path, _small_state(1))
    assert b.step == 1 and b.lr == 5e-4 and b.optimizer.param_groups[0]["step"] == 1
    ma, mb = _one_step(a, 2), _one_step(b, 2)
    assert ma["loss"].item() == mb["loss"].item()
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    assert torch.equal(a.aug_generator.get_state(), b.aug_generator.get_state())
    with pytest.raises(ValueError, match="not a training checkpoint"):
        from tpuseg_torch.utils.checkpoint import save_model

        save_model(str(tmp_path / "m.pt"), a.model)
        restore_train_state(str(tmp_path / "m.pt"), b)


def test_prefetch_cpu_order_widening_and_close():
    from tpuseg_torch.train.prefetch import device_prefetch

    batches = [(np.full((2, 4, 4, 1), 60000 + i, np.uint16), np.full((2, 4, 4), i, np.uint8))
               for i in range(5)]
    pulled = []

    def source():
        for b in batches:
            pulled.append(1)
            yield b

    it = device_prefetch(source(), "cpu", depth=2)
    for i in range(3):
        img, msk = next(it)
        assert img.dtype == torch.int32 and int(img[0, 0, 0, 0]) == 60000 + i
        assert msk.dtype == torch.uint8 and int(msk[0, 0, 0]) == i
    it.close()
    assert len(pulled) <= 3 + 2 + 1  # consumed + queue depth + one in flight

    def broken():
        yield batches[0]
        raise OSError("reader died")

    it = device_prefetch(broken(), "cpu")
    next(it)
    with pytest.raises(OSError, match="reader died"):
        next(it)
