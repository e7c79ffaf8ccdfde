"""The port's process-group wiring (tpuseg_torch/parallel/distributed.py),
its trainer guard, its dry run and its torchrun launcher, on the CPU.
Counterpart of tests/test_distributed.py and of tests/test_launchers.py's
multi-host cases.

Process groups form over gloo on 127.0.0.1: in this process at world size
1, and as two child processes given torchrun's environment."""

import os
import socket
import stat
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from tpuseg_torch.parallel import distributed
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _port_taken(err: str) -> bool:
    """The TCP store's failure when another process bound the port between
    ``_free_port`` and the store (EADDRINUSE). These tests drive the TCP
    rendezvous itself, so they bind again on another port."""
    return "EADDRINUSE" in err or "address already in use" in err.lower()


@pytest.fixture
def no_torchrun(monkeypatch):
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)


def test_process_local_batch_math(monkeypatch):
    assert distributed.process_local_batch_size(32) == 32
    assert distributed.process_local_batch_slice(32) == slice(0, 32)
    # process 2 of 4
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    monkeypatch.setattr(distributed, "process_index", lambda: 2)
    assert distributed.process_local_batch_size(32) == 8
    assert distributed.process_local_batch_slice(32) == slice(16, 24)
    with pytest.raises(ValueError, match="not divisible by 4 hosts"):
        distributed.process_local_batch_size(30)


def test_process_local_batch_checks_data_shards(monkeypatch):
    """16 data shards over 4 processes: 4 per process, so a per-process
    batch must split 4 ways (the JAX package's check, with its message)."""
    monkeypatch.setattr(distributed, "process_count", lambda: 4)
    assert distributed.process_local_batch_size(16, data_shards=16) == 4
    with pytest.raises(ValueError, match="data shards per host"):
        distributed.process_local_batch_size(24, data_shards=16)
    # one shard per process (the default): any per-process batch splits
    assert distributed.process_local_batch_size(12) == 3
    # spatial pairs: 2 data shards over 4 processes, and each group's
    # first process reads its shard's whole batch (tests/test_distributed.py
    # passes data_shards for the same reason)
    assert distributed.process_local_batch_size(12, data_shards=2) == 6
    with pytest.raises(ValueError, match="not divisible by 2 data shards"):
        distributed.process_local_batch_size(13, data_shards=2)


def test_spatial_groups_may_not_straddle_hosts(monkeypatch):
    """Counterpart of tests/test_distributed.py's straddle test: spatial
    groups of 4 consecutive ranks on hosts of 2 processes would cross the
    network for every halo; groups of 2 stay inside a host."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="straddle"):
        distributed.check_spatial_groups(4)
    distributed.check_spatial_groups(2)
    distributed.check_spatial_groups(1)


def test_single_process_defaults(no_torchrun):
    assert not distributed.is_initialized()
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)
    assert (distributed.local_rank(), distributed.local_world_size()) == (0, 1)
    assert distributed.host_count() == 1
    assert distributed.host_barrier("t0") == "single-process"
    assert distributed.broadcast_seed(1234) == 1234


def test_initialize_needs_torchrun_env_or_explicit_args(no_torchrun):
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.initialize_distributed(backend="gloo")
    with pytest.raises(ValueError, match="together"):
        distributed.initialize_distributed("127.0.0.1:1", num_processes=1)
    assert not distributed.is_initialized()


@pytest.mark.parametrize("how", ["explicit", "torchrun_env", "file"])
def test_initialize_world_size_one(no_torchrun, monkeypatch, tmp_path, how):
    for attempt in range(3):
        port = _free_port()
        if how == "file":  # a rendezvous no other process can take
            args = (f"file://{tmp_path}/rdzv", 1, 0)
        elif how == "explicit":
            args = (f"127.0.0.1:{port}", 1, 0)
        else:
            args = ()
            for k, v in dict(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                             MASTER_PORT=str(port)).items():
                monkeypatch.setenv(k, v)
        try:
            backend = distributed.initialize_distributed(*args, backend="gloo", timeout_s=30)
            break
        except Exception as e:  # noqa: BLE001 (the store's error type varies by release)
            if attempt == 2 or not _port_taken(str(e)):
                raise
    try:
        assert backend == "gloo"
        assert distributed.is_initialized()
        assert (distributed.process_index(), distributed.process_count()) == (0, 1)
        assert distributed.host_barrier("t1") == "single-process"
    finally:
        distributed.shutdown_distributed()
    assert not distributed.is_initialized()


CHILD = textwrap.dedent("""
    import sys, time

    if __name__ == "__main__":
        mode = sys.argv[1]
        from tpuseg_torch.parallel import distributed
        backend = distributed.initialize_distributed(backend="gloo", timeout_s=60)
        rank = distributed.process_index()
        print("GROUP", backend, rank, distributed.process_count(), distributed.local_rank(),
              distributed.local_world_size(), distributed.host_count())
        print("SEED", distributed.broadcast_seed(1000 + rank))
        if mode == "barrier":
            print("BARRIER", distributed.host_barrier("t2", timeout_s=30))
        elif rank == 0:  # rank 1 never arrives
            try:
                distributed.host_barrier("t3", timeout_s=2)
            except RuntimeError as e:
                print("RAISED", "t3" in str(e))
        else:
            time.sleep(6)
            sys.exit(0)
        distributed.shutdown_distributed()
""")


def _torchrun_pair(tmp_path, mode):
    """Two processes given torchrun's environment on one node; again on
    another port if rank 0 could not bind the first."""
    for _ in range(3):
        outs = _torchrun_pair_on(tmp_path, mode, str(_free_port()))
        if not _port_taken(outs[0][2]):
            return outs
    return outs


def _torchrun_pair_on(tmp_path, mode, port):
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, str(script), mode], env=env,
                                      cwd=str(REPO), stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_two_processes_from_torchrun_env(tmp_path):
    """Rank, world, local rank and hosts from torchrun's variables; the seed
    broadcast gives rank 0's draw everywhere; the barrier syncs."""
    outs = _torchrun_pair(tmp_path, "barrier")
    for rank, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        assert f"GROUP gloo {rank} 2 {rank} 2 1" in out
        assert "SEED 1000" in out and "BARRIER synced" in out


def test_host_barrier_raises_when_a_peer_does_not_arrive(tmp_path):
    outs = _torchrun_pair(tmp_path, "missing_peer")
    rc, out, err = outs[0]
    assert rc == 0, err[-3000:]
    assert "RAISED True" in out


def test_trainer_refuses_several_gpus_without_a_group(monkeypatch, no_torchrun):
    """Training on one of N visible cards would waste the others: it raises
    and names the torchrun command."""
    from tpuseg_torch.train import trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = trainer.TrainConfig("train.lmdb", "test.lmdb", "out", device="cuda")
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4 -m "
                                           "tpuseg_torch.cli.train --multihost 1"):
        trainer._train_device(cfg)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert trainer._train_device(cfg) == torch.device("cuda")
    assert trainer._train_device(trainer.TrainConfig("a", "b", "c", device="cpu")) == \
        torch.device("cpu")


def test_dryrun_two_gloo_ranks():
    """Two CPU ranks on a (1, 2) spatial mesh, as dryrun_multichip makes
    one: the train, ZeRO-1 and raw steps agree across the ranks through the
    halo exchange, a 48-row step gathers its rows at level 3, and sharded
    tiled serving equals one shard for every engine."""
    from tpuseg_torch.parallel.dryrun import dryrun_multigpu

    if torch.cuda.is_available():
        pytest.skip("with two cards the dry run takes them; this test pins the CPU path")
    res = dryrun_multigpu(2, timeout_s=240)
    assert res["ranks"] == 2 and res["backend"] == "gloo"
    assert res["mesh"] == [1, 2] and res["halo_route"] == "gloo"
    # 3 train steps of 18 + 17 exchanges and 3 eval steps of 18
    assert res["halo_exchanges"] == 3 * (35 + 18)
    for k in ("data_parallel", "zero1", "raw_zero1"):
        assert 0 < res[k] < 10
    # ZeRO-1 is the same update: the first loss (before it) is equal
    assert res["zero1"] == res["data_parallel"]
    assert set(res["serving"]) == {"none", "int8", "int8_blocked"}
    # 48 rows: 3 a rank at level 3, gathered before the fourth pool; a
    # train step gathers forward and backward, an eval step forward
    st = res["straddle"]
    assert st["split_level"] == 3 and st["gathers"] == 3
    assert 0 < st["loss"] < 10 and 0 < st["eval"] < 10


def _stub_python(bin_dir: Path, capture: Path) -> None:
    stub = bin_dir / "python"
    stub.write_text("#!/bin/bash\n"
                    f"printf '%s\\n' \"$@\" > {capture}\n"
                    "echo stub-train-ran\n")
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)


def _launch(tmp_path, **env_extra):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    capture = tmp_path / "argv.txt"
    _stub_python(bin_dir, capture)
    out_dir = tmp_path / "results"
    env = {k: v for k, v in os.environ.items() if k not in ("SLURM_PROCID", "NODE_RANK")}
    env.update(PATH=f"{bin_dir}:{env['PATH']}", TRAIN_DATABASE=str(tmp_path / "train-x.lmdb"),
               TEST_DATABASE=str(tmp_path / "test-x.lmdb"), OUTPUT_DIR=str(out_dir),
               GPUS_PER_NODE="2", **env_extra)
    proc = subprocess.run([str(REPO / "scripts" / "batch_train_multihost_torch.sh"),
                           "--shard_optimizer", "1"],
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return capture.read_text().splitlines(), out_dir


def test_torch_launcher_invocation(tmp_path):
    argv, out_dir = _launch(tmp_path, NNODES="2", NODE_RANK="1", MASTER_ADDR="node0")
    assert argv[:2] == ["-m", "torch.distributed.run"]
    cut = argv.index("tpuseg_torch.cli.train")
    assert argv[cut - 1] == "-m"
    run = dict(zip(argv[2:cut - 1:2], argv[3:cut - 1:2]))
    assert run["--nnodes"] == "2" and run["--node_rank"] == "1"
    assert run["--nproc_per_node"] == "2" and run["--master_addr"] == "node0"
    assert run["--log_dir"] == str(out_dir / "logs_node1")
    flags = dict(zip(argv[cut + 1::2], argv[cut + 2::2]))
    assert flags["--multihost"] == "1" and flags["--batch_size"] == "8"
    assert flags["--train_database"].endswith("train-x.lmdb")
    assert flags["--output_dir"] == str(out_dir)
    assert argv[-2:] == ["--shard_optimizer", "1"]
    # node 1: its own log, and no snapshot race with node 0
    assert "stub-train-ran" in (out_dir / "log_node1.txt").read_text()
    assert not (out_dir / "git_commit.txt").exists()


def test_torch_launcher_node0_snapshots(tmp_path):
    _, out_dir = _launch(tmp_path)
    assert (out_dir / "log_node0.txt").exists()
    assert (out_dir / "git_commit.txt").exists()
    assert (out_dir / "source_snapshot.tar.gz").exists()
