"""Data parallelism in the port (tpuseg_torch/parallel/mesh.py) on the CPU:
two gloo ranks against one process on the global batch, and against the
JAX package's sharded step on its 8-device CPU mesh. Counterpart of
tests/test_parallel.py.

Each run is a child process (the same script with one rank and no process
group is the one-process reference): base 4, f32, 32^2 inputs, a global
batch of 4 over 2 steps, two samples per rank. Tolerances:

- two ranks against one process, dropout and augmentation on: loss rtol
  1e-5 and accuracy atol 1e-6 (both steps, and an eval step), BatchNorm
  running statistics atol 1e-5, parameters atol 2e-5 after the first step
  (tests/test_parallel.py), and the ranks' states bit-equal. The parameter
  tolerance cannot hold for every element: Keras Adam's first update is
  about lr * g/(|g| + eps') (tests/test_torch_steps.py explains it), so
  where |g| is near eps' = 3e-6 the gradients' last-bit differences show
  (measured: 8 of 10^6 elements beyond 2e-5, the largest 5.3e-5 = lr/19).
  So at least 99.99% of the elements are held to 2e-5 and every one to
  lr/4; the gradients themselves (DDP's mean, through the sync-BN
  all-reduces) to 1e-3 of each tensor's largest, tests/test_torch_steps.py's
  gradient tolerance (measured 6e-5);
- ZeRO-1 against replicated: loss rtol 1e-6, parameters atol 2e-6
  (tests/test_parallel.py);
- against the JAX package's sharded step, dropout off: the tolerances of
  tests/test_torch_steps.py.
"""

import os
import subprocess
import sys
import textwrap
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3

CHILD = textwrap.dedent("""
    import sys

    if __name__ == "__main__":
        rank, world, rdzv, work, mode = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                         sys.argv[4], sys.argv[5])
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from tpuseg_torch.parallel import distributed, mesh as mesh_lib
        if world > 1:
            distributed.initialize_distributed(rdzv, world, rank, backend="gloo",
                                               timeout_s=120)
        from tpuseg_torch.models.unet import UNet
        from tpuseg_torch.train.steps import create_train_state
        from tpuseg_torch.utils.checkpoint import optimizer_state

        zero = mode.startswith("zero")
        state = create_train_state(UNet(2, 1, 4, "float32"), 0, 1e-3, "cpu")  # LR
        if mode == "jax":
            state.model.load_state_dict(torch.load(f"{work}/init.pt", weights_only=True))
            state.model.dropout_rate = 0.0
        if rank == 1:  # replicate_state must make it rank 0's
            with torch.no_grad():
                for p in state.model.parameters():
                    p.add_(1.0)
        mesh = mesh_lib.make_mesh("cpu")
        mesh_lib.replicate_state(state, mesh)
        data = np.load(f"{work}/data.npz")
        per = data["img"].shape[1] // world
        rows = slice(rank * per, (rank + 1) * per)
        raw = mode in ("raw", "zero_raw")
        if raw:
            tstep, estep = mesh_lib.make_parallel_raw_steps(
                state.model, mesh, 2, shard_optimizer=zero, state=state)
            xs, ys = data["img"], data["msk"]
        else:
            tstep, estep = mesh_lib.make_parallel_steps(
                state.model, mesh, shard_optimizer=zero, state=state)
            xs, ys = data["x"], data["y"]
        mesh_lib.warm_collectives(mesh)

        import torch.distributed.nn.functional as dnn
        calls = []
        real = dnn.all_reduce
        dnn.all_reduce = lambda *a, **k: calls.append(1) or real(*a, **k)
        out = {"loss": [], "acc": []}
        for step in range(xs.shape[0]):
            m = tstep(state, torch.from_numpy(xs[step, rows]), torch.from_numpy(ys[step, rows]))
            out["loss"].append(m["loss"].item())
            out["acc"].append(m["accuracy"].item())
            if step == 0:
                dnn.all_reduce = real
                out["bn_allreduces_step0"] = len(calls)
                out["state_dict_step0"] = {k: v.clone() for k, v in
                                           state.model.state_dict().items()}
                out["grads_step0"] = {k: p.grad.clone() for k, p in
                                      state.model.named_parameters()}
                m = estep(state, torch.from_numpy(xs[0, rows]), torch.from_numpy(ys[0, rows]))
                out["eval"] = [m["loss"].item(), m["accuracy"].item()]
        out["state_dict"] = {k: v.clone() for k, v in state.model.state_dict().items()}
        out["opt_step"] = state.optimizer.param_groups[0]["step"]
        if zero:
            index = {p: i for i, p in enumerate(state.model.parameters())}
            out["local_moments"] = sorted(index[p] for p in state.optimizer.optim.state)
        out["optimizer"] = optimizer_state(state.optimizer)
        torch.save(out, f"{work}/out_{mode}_{world}_{rank}.pt")
        # every rank's last collective done before any tears down its
        # pairs (else a rank now and then aborts at exit)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        distributed.shutdown_distributed()
""")


def _rendezvous(work) -> str:
    """A file rendezvous for one group of children: a new file in the
    test's own directory, which no other process can take (a port found
    free and closed again can be bound by another process before the
    children bind it)."""
    return f"file://{work}/rdzv-{uuid.uuid4().hex}"


def _run(work, mode, world):
    """Run ``mode`` on ``world`` ranks (1: one process, no process group);
    returns each rank's results."""
    script = os.path.join(work, "child.py")
    with open(script, "w") as f:
        f.write(CHILD)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rdzv = _rendezvous(work)
    procs = [subprocess.Popen([sys.executable, script, str(r), str(world), rdzv, work, mode],
                              cwd=str(REPO), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [torch.load(os.path.join(work, f"out_{mode}_{world}_{r}.pt"), weights_only=False)
            for r in range(world)]


def _data(work, seed=7, steps=2, batch=4, size=32):
    """``steps`` raw global batches (uint16-range images, uint8 masks) and
    as many preprocessed ones (z-scored images, one-hot labels)."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 4000, (steps, batch, size, size, 1)).astype(np.int32)
    msk = (img[..., 0] + rng.normal(0, 600, img.shape[:4]) > 2000).astype(np.uint8)
    x = rng.normal(0, 1, (steps, batch, size, size, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[..., 0] + rng.normal(0, 0.5, x.shape[:4]) > 0)
                                    .astype(np.int32)]
    np.savez(os.path.join(work, "data.npz"), img=img, msk=msk, x=x, y=y)
    return x, y


def _assert_same_ranks(a, b):
    for k in a["state_dict"]:
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
    assert a["loss"] == b["loss"] and a["acc"] == b["acc"] and a["eval"] == b["eval"]


@pytest.mark.parametrize("mode", ["raw", "host"])
def test_two_ranks_match_one_process_on_the_global_batch(tmp_path, mode):
    """Dropout on, and on the raw path augmentation too: both are drawn for
    the global batch, so two ranks of 2 train as one process of 4."""
    work = str(tmp_path)
    _data(work)
    ranks = _run(work, mode, 2)
    (one,) = _run(work, mode, 1)
    _assert_same_ranks(*ranks)
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], one["acc"], atol=1e-6)
    np.testing.assert_allclose(got["eval"][0], one["eval"][0], rtol=1e-5)
    np.testing.assert_allclose(got["eval"][1], one["eval"][1], atol=1e-6)
    for k, g in one["grads_step0"].items():
        err = (got["grads_step0"][k] - g).abs().max() / g.abs().max()
        assert err < 1e-3, (k, err)
    n = n_ok = 0
    for k, v in one["state_dict_step0"].items():
        d = (got["state_dict_step0"][k] - v).abs()
        if "running" in k:
            assert d.max() <= 1e-5, (k, d.max())
        elif "num_batches" not in k:
            n += d.numel()
            n_ok += int((d <= 2e-5).sum())
            assert d.max() <= LR / 4, (k, d.max())
    print(f"parameters within 2e-5 after one step: {n_ok / n:.6f}")
    assert n_ok / n >= 0.9999
    for k, v in one["state_dict"].items():
        if "running" in k:
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)
    # sync-BN: one forward all-reduce per BatchNorm layer
    assert got["bn_allreduces_step0"] == 23
    assert one["bn_allreduces_step0"] == 0
    assert got["opt_step"] == one["opt_step"] == 2


@pytest.mark.parametrize("path", ["raw", "host"])
def test_zero1_matches_replicated(tmp_path, path):
    """ZeRO-1 against the replicated optimizer, two ranks each: the same
    training, each rank holding its partition's moments only, and rank
    0's gathered optimizer state in KerasAdam's layout, which a
    single-process KerasAdam loads."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.train.steps import KerasAdam

    work = str(tmp_path)
    _data(work)
    rep = _run(work, path, 2)
    zero = _run(work, "zero_" + path, 2)
    _assert_same_ranks(*zero)
    np.testing.assert_allclose(zero[0]["loss"], rep[0]["loss"], rtol=1e-6)
    for k, v in rep[0]["state_dict"].items():
        np.testing.assert_allclose(zero[0]["state_dict"][k].numpy(), v.numpy(), atol=2e-6,
                                   err_msg=k)
    n = len(list(UNet(2, 1, 4, "float32").parameters()))
    parts = [set(r["local_moments"]) for r in zero]
    assert parts[0] and parts[1] and not parts[0] & parts[1]
    assert parts[0] | parts[1] == set(range(n))
    assert zero[1]["optimizer"] is None and rep[1]["optimizer"] is not None
    doc, want = zero[0]["optimizer"], rep[0]["optimizer"]
    assert doc["param_groups"][0].keys() == want["param_groups"][0].keys()
    assert doc["param_groups"][0]["step"] == 2 and sorted(doc["state"]) == list(range(n))
    for i, st in want["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(doc["state"][i][key].numpy(), st[key].numpy(),
                                       atol=1e-6, rtol=1e-5)
    template = UNet(2, 1, 4, "float32")
    opt = KerasAdam(template.parameters())
    opt.load_state_dict(doc)
    assert opt.param_groups[0]["step"] == 2 and len(opt.state) == n


def test_two_ranks_match_jax_sharded_step(tmp_path, monkeypatch):
    """The same flax weights through the bridge: the port's two gloo ranks
    of 4 samples against the JAX package's data-parallel step on its
    8-device CPU mesh over the global batch of 8, dropout off in both."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.models.unet import init_variables
    from tpuseg.parallel import mesh as jmesh
    from tpuseg.train import steps as jsteps
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.utils.jax_bridge import flax_to_state_dict

    from test_torch_steps import LR as STEPS_LR
    from test_torch_steps import _assert_state_close

    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    work = str(tmp_path)
    x, y = _data(work, seed=11, batch=8)
    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, init_variables(model, jax.random.PRNGKey(3), num_channels=1))
    torch.save(flax_to_state_dict(variables), os.path.join(work, "init.pt"))
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8
    assert STEPS_LR == LR
    jstate = jsteps.create_train_state(model, jax.random.PRNGKey(0), 1, LR)
    jstate = jmesh.replicate_state(
        jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"]), mesh)
    tstep, _ = jmesh.make_parallel_steps(model, mesh)
    want = []
    for step in range(x.shape[0]):
        jstate, m = tstep(jstate, *jmesh.shard_batch(mesh, jnp.asarray(x[step]),
                                                    jnp.asarray(y[step])))
        want.append((float(m["loss"]), float(m["accuracy"])))

    got = _run(work, "jax", 2)
    _assert_same_ranks(*got)
    np.testing.assert_allclose(got[0]["loss"], [w[0] for w in want], rtol=1e-5)
    np.testing.assert_allclose(got[0]["acc"], [w[1] for w in want], atol=1e-6)
    port = UNet(2, 1, 4, "float32")
    port.load_state_dict(got[0]["state_dict"])
    jstate = jax.tree_util.tree_map(np.asarray, jstate)
    _assert_state_close(jstate, port)


def test_make_mesh_without_a_group_and_spatial():
    from tpuseg_torch.parallel import mesh as mesh_lib

    m = mesh_lib.make_mesh("cpu")
    assert (m.world, m.rank, m.group) == (1, 0, None)
    assert (m.data, m.spatial, m.data_rank, m.spatial_rank, m.halo) == (1, 1, 0, 0, None)
    # one process cannot form a spatial group of 2
    with pytest.raises(ValueError, match="not divisible by spatial=2"):
        mesh_lib.make_mesh("cpu", spatial=2)


def test_steps_without_a_group_are_the_plain_steps():
    """No process group: the plain pair, no DDP and no collectives, as the
    JAX package returns its plain jitted pair on a one-device mesh."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.train.steps import create_train_state

    state = create_train_state(UNet(2, 1, 4, "float32"), 0, 1e-3, "cpu")
    mesh = mesh_lib.make_mesh("cpu")
    tstep, _ = mesh_lib.make_parallel_steps(state.model, mesh, shard_optimizer=True, state=state)
    x = torch.zeros(2, 16, 16, 1)
    y = torch.nn.functional.one_hot(torch.zeros(2, 16, 16, dtype=torch.long), 2)
    assert torch.isfinite(tstep(state, x, y)["loss"])
    assert state.model.process_group is None
    assert type(state.optimizer).__name__ == "KerasAdam"
    mesh_lib.warm_collectives(mesh)  # no group: nothing to warm


def test_warm_collectives_raises_on_a_wrong_sum(monkeypatch):
    from tpuseg_torch.parallel import mesh as mesh_lib

    monkeypatch.setattr(mesh_lib.dist, "all_reduce", lambda t, group=None: None)
    with pytest.raises(RuntimeError, match="expected 2"):
        mesh_lib.warm_collectives(mesh_lib.Mesh(2, 0, torch.device("cpu"), group=object()))
