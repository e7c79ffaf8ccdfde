"""The PyTorch/CUDA port's launchers (scripts/*_torch.{sh,py}), the layer
above its CLIs; counterpart of tests/test_launchers.py. The shell
launchers run with a stub ``python`` on PATH, and the test asserts the
command each assembles: ``-m tpuseg_torch.cli.*``, its counterpart's
variables and defaults, overrides and extra flags passed through, and
batch_train_torch.sh's log, snapshot and TERM conventions. The Python
launchers run as ``__main__`` with the entry point patched, and the test
asserts the config each builds. setup_environment_torch.sh runs for real
against this machine's torch."""

import os
import runpy
import signal
import stat
import subprocess
import tarfile
import time
from pathlib import Path

import pytest
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"


def _stub_python(bin_dir: Path, capture: Path, then: str = "") -> None:
    stub = bin_dir / "python"
    stub.write_text("#!/bin/bash\n"
                    f"printf '%s\\n' \"$@\" > {capture}\n"
                    "echo stub-train-ran\n" + then)
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)


def _env(tmp_path: Path, then: str = "", **extra):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    capture = tmp_path / "argv.txt"
    _stub_python(bin_dir, capture, then)
    # the launchers' variables come from ``extra`` alone; no SLURM_JOB_ID,
    # so no /scratch staging
    env = {k: v for k, v in os.environ.items()
           if k != "SLURM_JOB_ID" and k not in VARIABLES}
    env.update(PATH=f"{bin_dir}:{env['PATH']}", **extra)
    return env, capture


def _run(script: str, tmp_path: Path, args=(), **extra):
    env, capture = _env(tmp_path, **extra)
    proc = subprocess.run([str(SCRIPTS / script), *args], env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return capture.read_text().splitlines(), proc


# script -> (CLI module, {flag: default}); "REPO/" stands for the checkout
LAUNCHERS = {
    "train_torch.sh": ("tpuseg_torch.cli.train", {
        "--train_database": "REPO/data/train-HES.lmdb",
        "--test_database": "REPO/data/test-HES.lmdb",
        "--output_dir": "REPO/output", "--batch_size": "4", "--number_classes": "2",
        "--learning_rate": "3e-4", "--use_augmentation": "1", "--balance_classes": "0",
        "--reader_count": "1"}),
    "inference_torch.sh": ("tpuseg_torch.cli.inference", {
        "--checkpoint_filepath": "REPO/output/checkpoint/ckpt",
        "--image_folder": "REPO/data/images", "--output_folder": "REPO/inference_output",
        "--number_classes": "2", "--number_channels": "1", "--image_format": "tif"}),
    "build_lmdb_torch.sh": ("tpuseg_torch.cli.build_lmdb", {
        "--image_folder": "REPO/data/images", "--mask_folder": "REPO/data/masks",
        "--output_folder": "REPO/data", "--dataset_name": "HES",
        "--train_fraction": "0.8", "--image_format": "tif", "--use_tiling": "0",
        "--tile_size": "512"}),
}

# each flag's variable: the flag's name in capitals
VARIABLES = {flag[2:].upper() for _, flags in LAUNCHERS.values() for flag in flags}


def _counterpart_defaults(script: str) -> dict:
    """{variable: default} as the JAX package's launcher sets them."""
    out = {}
    for line in (SCRIPTS / script.replace("_torch", "")).read_text().splitlines():
        if line.startswith(tuple("ABCDEFGHIJKLMNOPQRSTUVWXYZ")) and ":-" in line:
            name, _, rest = line.partition("=")
            out[name] = rest.split(":-", 1)[1].rsplit("}", 1)[0]
    return out


@pytest.mark.parametrize("script", sorted(LAUNCHERS))
def test_shell_launcher_defaults(tmp_path, script):
    """With no variable set: the port's CLI with the defaults of the JAX
    package's launcher, paths anchored at the checkout."""
    argv, _ = _run(script, tmp_path)
    module, defaults = LAUNCHERS[script]
    assert argv[:2] == ["-m", module]
    flags = dict(zip(argv[2::2], argv[3::2]))
    assert flags == {k: v.replace("REPO/", f"{REPO}/") for k, v in defaults.items()}
    theirs = _counterpart_defaults(script)
    for flag, value in defaults.items():
        var = flag[2:].upper()
        assert theirs[var] == value.replace("REPO/", "${REPO_DIR}/"), (var, theirs[var])


@pytest.mark.parametrize("script", sorted(LAUNCHERS))
def test_shell_launcher_forwards_variables_and_flags(tmp_path, script):
    module, defaults = LAUNCHERS[script]
    extra = {flag[2:].upper(): f"v{i}" for i, flag in enumerate(defaults)}
    argv, _ = _run(script, tmp_path, args=("--device", "cpu", "--seed", "3"), **extra)
    assert argv[:2] == ["-m", module]
    flags = dict(zip(argv[2::2], argv[3::2]))
    assert flags == {flag: f"v{i}" for i, flag in enumerate(defaults)} | {
        "--device": "cpu", "--seed": "3"}
    assert argv[-4:] == ["--device", "cpu", "--seed", "3"]


def _batch_env(tmp_path: Path, then: str = ""):
    out_dir = tmp_path / "results"
    env, capture = _env(tmp_path, then, TRAIN_DATABASE=str(tmp_path / "train-x.lmdb"),
                        TEST_DATABASE=str(tmp_path / "test-x.lmdb"), OUTPUT_DIR=str(out_dir))
    return env, capture, out_dir


def test_batch_train_torch_invocation(tmp_path):
    env, capture, out_dir = _batch_env(tmp_path)
    proc = subprocess.run([str(SCRIPTS / "batch_train_torch.sh"), "--number_classes", "4"],
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    argv = capture.read_text().splitlines()
    assert argv[:2] == ["-m", "tpuseg_torch.cli.train"]
    flags = dict(zip(argv[2::2], argv[3::2]))
    assert flags["--train_database"].endswith("train-x.lmdb")
    assert flags["--test_database"].endswith("test-x.lmdb")
    assert flags["--output_dir"] == str(out_dir)
    # batch_train.sh's defaults: 8 a GPU, 2 readers
    assert flags["--batch_size"] == "8" and flags["--reader_count"] == "2"
    assert argv[-2:] == ["--number_classes", "4"]
    # the tee to log.txt, the commit and the snapshot of the port's sources
    assert "stub-train-ran" in (out_dir / "log.txt").read_text()
    assert (out_dir / "git_commit.txt").exists()
    with tarfile.open(out_dir / "source_snapshot.tar.gz") as tar:
        tops = {name.split("/")[0] for name in tar.getnames()}
    assert tops == {"tpuseg_torch", "scripts"}


def test_batch_train_torch_requires_databases(tmp_path):
    env, _, _ = _batch_env(tmp_path)
    env.pop("TRAIN_DATABASE")
    proc = subprocess.run([str(SCRIPTS / "batch_train_torch.sh")], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "TRAIN_DATABASE" in proc.stderr


def test_batch_train_torch_exits_143_on_term(tmp_path):
    """A scheduler's TERM (sent to the job's process group) ends the run
    with 143, never 0: a preempted run must not look finished."""
    started = tmp_path / "started"
    env, _, _ = _batch_env(tmp_path, then=f"touch {started}\nexec sleep 60\n")
    proc = subprocess.Popen([str(SCRIPTS / "batch_train_torch.sh")], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        deadline = time.monotonic() + 30
        while not started.exists():
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        os.killpg(proc.pid, signal.SIGTERM)
        out, _ = proc.communicate(timeout=30)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 143
    assert "TERM received" in out


def _patched_main(monkeypatch, module: str, name: str, path: Path):
    import importlib

    calls = []
    monkeypatch.setattr(importlib.import_module(module), name,
                        lambda *a, **k: calls.append((a, k)))
    runpy.run_path(str(path), run_name="__main__")
    assert len(calls) == 1
    return calls[0]


def test_launch_train_torch_config(monkeypatch):
    from tpuseg_torch.train.trainer import TrainConfig

    (cfg,), kw = _patched_main(monkeypatch, "tpuseg_torch.train.trainer", "train_model",
                               SCRIPTS / "launch_train_torch.py")
    assert not kw
    assert cfg == TrainConfig(
        train_database="../data/train-HES.lmdb", test_database="../data/test-HES.lmdb",
        output_folder="../output", batch_size=4, number_classes=2, learning_rate=3e-4,
        test_every_n_steps=1000, balance_classes=False, use_augmentation=True,
        early_stopping_count=10, reader_count=1)
    assert cfg.device == "cuda"


def test_launch_inference_torch_config(monkeypatch):
    from tpuseg_torch.infer.runner import InferenceConfig

    (cfg,), kw = _patched_main(monkeypatch, "tpuseg_torch.infer.runner", "inference",
                               SCRIPTS / "launch_inference_torch.py")
    assert not kw
    assert cfg == InferenceConfig(
        checkpoint_filepath="../output/checkpoint/ckpt", image_folder="../data/images",
        output_folder="../inference_output", number_classes=2, number_channels=1,
        image_format="tif")
    assert cfg.device == "cuda"


def test_launch_build_lmdb_torch_config(monkeypatch):
    args, kw = _patched_main(monkeypatch, "tpuseg_torch.data.build_db", "build_databases",
                             SCRIPTS / "launch_build_lmdb_torch.py")
    assert not args
    assert kw == dict(image_folder="../data/images", mask_folder="../data/masks",
                      output_folder="../data", dataset_name="HES", train_fraction=0.8,
                      image_format="tif", use_tiling=False, tile_size=512)


@pytest.mark.parametrize("name", ["train", "inference", "build_lmdb"])
def test_python_launchers_import_only_the_port(name):
    """The port's launchers drop the JAX package's compile cache and name
    nothing of ``tpuseg`` outside ``tpuseg_torch``; their constants are
    their counterparts'."""
    import ast

    ours = (SCRIPTS / f"launch_{name}_torch.py").read_text()
    theirs = (SCRIPTS / f"launch_{name}.py").read_text()
    imports = [n.module for n in ast.walk(ast.parse(ours)) if isinstance(n, ast.ImportFrom)]
    assert imports and all(m.startswith("tpuseg_torch.") for m in imports)
    assert "compile_cache" not in ours

    def constants(src):
        return {n.targets[0].id: ast.literal_eval(n.value) for n in ast.parse(src).body
                if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)}

    assert constants(ours) == constants(theirs)


def test_setup_environment_torch_cpu():
    """--cpu checks that torch imports and stops there."""
    proc = subprocess.run([str(SCRIPTS / "setup_environment_torch.sh"), "--cpu"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import torch

    assert f"torch {torch.__version__}" in proc.stdout
    assert "CPU environment ready" in proc.stdout


def test_setup_environment_torch_needs_a_card_without_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the script would build the kernels")
    proc = subprocess.run([str(SCRIPTS / "setup_environment_torch.sh")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    assert "torch sees no CUDA card" in proc.stderr
    bad = subprocess.run([str(SCRIPTS / "setup_environment_torch.sh"), "--gpu"],
                         capture_output=True, text=True, timeout=60)
    assert bad.returncode == 2 and "usage" in bad.stderr
