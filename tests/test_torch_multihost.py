"""Two processes in one gloo process group on the CPU, through the port's
entry points: ``train_model`` (replicated and ZeRO-1) and ``cli.inference
--multihost 1``. Counterpart of tests/test_multihost_integration.py.

Training (base 2, 32^2, batch 1 per replica, 2 steps between test
epochs; replicated, ZeRO-1, and spatially partitioned over the two
processes as one replica, also on 48 x 32 records, whose fourth pool
window straddles the two): both processes report the global batch and
identical test-loss trajectories, rank 0 alone writes the artifacts, the
ZeRO-1 run resumes from its checkpoint, and rank 0's checkpoint restores
into a one-process template. Serving (base 4, int8_blocked): the two processes' stripes of
the folder give the masks one process gives, from the same calibration
scales."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuseg_torch.data.build_db import serialize_image_mask_pair
from tpuseg_torch.data.recordstore import RecordWriter
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]

TRAIN_CHILD = textwrap.dedent("""
    import os, sys

    # the __main__ guard is load-bearing: the readers' forkserver workers
    # would otherwise join the process group again
    if __name__ == "__main__":
        rank, rdzv = int(sys.argv[1]), sys.argv[2]
        train_db, test_db, out = sys.argv[3:6]
        zero, spatial = sys.argv[6] == "1", int(sys.argv[7])
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tpuseg_torch.parallel import distributed
        distributed.initialize_distributed(rdzv, 2, rank, backend="gloo", timeout_s=120)
        from tpuseg_torch.train.trainer import TrainConfig, train_model
        kw = dict(batch_size=1, test_every_n_steps=2, early_stopping_count=5,
                  dtype="float32", base_features=2, seed=0, device="cpu",
                  shard_optimizer=zero, spatial_partitions=spatial)
        result = train_model(TrainConfig(train_db, test_db, out, max_epochs=2, **kw))
        print("RESULT", rank, result.epochs_run, result.steps,
              ",".join(f"{v:.7f}" for v in result.test_loss))
        ckpt = os.path.join(out, "checkpoint", "ckpt")
        if zero:  # every process restores host-locally and goes on
            again = train_model(TrainConfig(train_db, test_db, out + "_resume", max_epochs=3,
                                            resume_checkpoint=ckpt, **kw))
            print("RESUMED", rank, again.epochs_run, again.steps,
                  ",".join(f"{v:.7f}" for v in again.test_loss))
        if rank == 0:  # into a one-process template
            from tpuseg_torch.models.unet import UNet
            from tpuseg_torch.train.steps import create_train_state
            from tpuseg_torch.utils.checkpoint import restore_train_state
            template = create_train_state(UNet(2, 1, 2, "float32"), 1, 3e-4, "cpu")
            restore_train_state(ckpt, template)
            moments = [t for st in template.optimizer.state.values() for t in st.values()]
            n = len(list(template.model.parameters()))
            assert len(template.optimizer.state) == n
            total = float(sum(t.abs().sum() for t in moments))
            assert np.isfinite(total) and total > 0
            print("RESTORED", rank, template.step, template.optimizer.param_groups[0]["step"],
                  total)
        # every rank's last collective done before any tears down its
        # pairs (else a rank now and then aborts at exit)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        distributed.shutdown_distributed()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_taken(err: str) -> bool:
    return "EADDRINUSE" in err or "address already in use" in err.lower()


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
                **extra)


def _wait(procs, timeout=300):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _communicate(procs, timeout=300):
    return _check(_wait(procs, timeout))


def _on_a_free_port(start, attempts=3):
    """``start(port)`` -> the children; run them again on another port while
    one failed because another process bound the port between
    ``_free_port`` and the children (EADDRINUSE): the TCP rendezvous of
    torchrun's environment is what the test drives."""
    for _ in range(attempts):
        outs = _wait(start(str(_free_port())))
        if not any(rc != 0 and _port_taken(err) for rc, _, err in outs):
            break
    return _check(outs)


def _check(outs):
    for rc, out, err in outs:
        assert rc == 0, f"child failed:\n{out[-2000:]}\n{err[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(0)

    def make(path, n, height):
        with RecordWriter(str(path)) as w:
            for i in range(n):
                img = rng.normal(500, 100, (height, 32, 1)).astype(np.uint16)
                msk = (img[..., 0] > 500).astype(np.uint8)
                w.put(f"img{i:03d}:0,1", serialize_image_mask_pair(img, msk))
        return str(path)

    # height -> (train, test)
    return {h: (make(root / f"train-mh{h}.lmdb", 16, h), make(root / f"test-mh{h}.lmdb", 8, h))
            for h in (32, 48)}


def _lines(out, tag):
    return [line.split()[2:] for line in out.splitlines() if line.startswith(tag + " ")]


@pytest.mark.parametrize("zero,spatial,height",
                         [(False, 1, 32), (True, 1, 32), (False, 2, 32), (False, 2, 48)],
                         ids=["replicated", "zero1", "spatial", "spatial_straddling"])
def test_two_process_train_model(dbs, tmp_path, zero, spatial, height):
    """The spatial case is tests/test_multihost_integration.py's: the two
    processes are one host's spatial group, one replica, so the global
    batch halves; the first process reads and the halos cross between
    them. At 48 rows a process holds 3 at level 3, and the trainer gathers
    them before the fourth pool."""
    script = tmp_path / "child.py"
    script.write_text(TRAIN_CHILD)
    out = str(tmp_path / "out")
    rdzv = f"file://{tmp_path}/rdzv"
    # explicit initialization is one process per host unless told otherwise
    env = _env(LOCAL_WORLD_SIZE="2") if spatial > 1 else _env()
    outs = _communicate([
        subprocess.Popen([sys.executable, str(script), str(rank), rdzv, *dbs[height], out,
                          "1" if zero else "0", str(spatial)], env=env, cwd=str(REPO),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)])
    hosts = 1 if spatial > 1 else 2
    for _, stdout, _ in outs:
        assert (f"devices = 2 over {hosts} host(s), global_batch_size = {2 // spatial}"
                in stdout)
        if spatial > 1:
            assert "halo route gloo" in stdout
            assert ("rows gathered at level 3" in stdout) == (height == 48)
    # the test loss is a global mean: identical on both processes
    results = [_lines(o[1], "RESULT") for o in outs]
    assert results[0] == results[1] and len(results[0]) == 1
    epochs, steps, losses = results[0][0]
    assert (epochs, steps) == ("2", "6") and len(losses.split(",")) == 2
    if zero:
        resumed = [_lines(o[1], "RESUMED") for o in outs]
        assert resumed[0] == resumed[1]
        epochs, steps, losses = resumed[0][0]
        assert int(steps) >= 6 + 3 and losses.split(",")[:2] == results[0][0][2].split(",")
        assert all("Resumed training state" in o[1] for o in outs)
    (restored,) = _lines(outs[0][1], "RESTORED")
    assert restored[0] == restored[1] and int(restored[0]) in (3, 6)
    # artifacts written once, by rank 0
    assert os.path.isfile(os.path.join(out, "checkpoint", "ckpt"))
    with open(os.path.join(out, "test_loss.csv")) as f:
        assert [f"{float(v):.7f}" for v in f.read().split()] == results[0][0][2].split(",")
    assert len([d for d in os.listdir(out) if d.startswith("tensorboard-")]) == 1


def test_spatial_partitions_raise(dbs, tmp_path):
    """A spatial group of 2 needs 2 processes; and N must be positive."""
    from tpuseg_torch.train.trainer import TrainConfig, train_model

    for spatial in (2, 0):
        with pytest.raises(ValueError, match="spatial"):
            train_model(TrainConfig(*dbs[32], str(tmp_path / "out"), device="cpu",
                                    spatial_partitions=spatial))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A base-4 checkpoint and a folder of four images (one tiled)."""
    from tpuseg_torch.utils.checkpoint import save_model
    from tpuseg_torch.utils.imagio import imwrite
    from tpuseg_torch.utils.jax_bridge import unet_from_flax

    from test_torch_unet import jax_model_and_vars

    root = tmp_path_factory.mktemp("serve")
    _, variables = jax_model_and_vars()
    ckpt = str(root / "port.pt")
    save_model(ckpt, unet_from_flax(variables, 2, 1, 4, torch.float32))
    imgdir = root / "imgs"
    imgdir.mkdir()
    rng = np.random.default_rng(0)
    for name, shape in {"a_small.tif": (48, 40), "b_big.tif": (100, 140),
                        "c_small.tif": (48, 40), "d_small.tif": (48, 40)}.items():
        imwrite(str(imgdir / name), rng.integers(0, 4096, shape).astype(np.uint16))
    return ckpt, str(imgdir)


def _serve_args(served, out, cal):
    ckpt, imgdir = served
    return ["--checkpoint_filepath", ckpt, "--image_folder", imgdir, "--output_folder", out,
            "--number_classes", "2", "--number_channels", "1", "--base_features", "4",
            "--tile_size", "64", "--batch_size", "2", "--radius", "16", "--device", "cpu",
            "--quantize", "int8_blocked", "--calibration_out", cal]


def test_two_process_inference_stripes_the_folder(served, tmp_path):
    """Two torchrun-style processes of cli.inference --multihost 1: each
    writes its stripe, the masks are one process's, and both derive the
    one process's calibration scales."""
    from tpuseg_torch.cli.inference import main
    from tpuseg_torch.utils.imagio import imread

    one_out, multi_out = str(tmp_path / "one"), str(tmp_path / "multi")
    main(_serve_args(served, one_out, str(tmp_path / "cal_one.json")))
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from tpuseg_torch.cli.inference import main; main(sys.argv[1:])")
    outs = _on_a_free_port(lambda port: [
        subprocess.Popen([sys.executable, "-c", code, "--multihost", "1",
                          *_serve_args(served, multi_out, str(tmp_path / f"cal{rank}.json"))],
                         env=_env(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                                  LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                                  MASTER_PORT=port),
                         cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for rank in range(2)])
    assert "process 0/2: segmenting 2 of 4 images" in outs[0][1]
    assert "process 1/2: segmenting 2 of 4 images" in outs[1][1]
    names = sorted(os.listdir(one_out))
    assert sorted(os.listdir(multi_out)) == names and len(names) == 4
    for name in names:
        a, b = imread(os.path.join(one_out, name)), imread(os.path.join(multi_out, name))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    scales = [json.load(open(tmp_path / f)) for f in ("cal_one.json", "cal0.json", "cal1.json")]
    assert scales[0] == scales[1] == scales[2]


def test_empty_stripe_warns_and_writes_nothing(served, tmp_path, capsys):
    from tpuseg_torch.infer.runner import InferenceConfig, inference

    ckpt, imgdir = served
    written = inference(InferenceConfig(
        ckpt, imgdir, str(tmp_path / "out"), 2, 1, base_features=4, tile_size=64,
        batch_size=2, radius=16, device="cpu", quantize="int8_blocked",
        calibration_out=str(tmp_path / "cal.json"), process_index=5, process_count=6))
    assert written == []
    out = capsys.readouterr().out
    assert "stripe of 4 images is empty" in out and "NOT written by this process" in out
    assert not os.path.exists(tmp_path / "cal.json")
