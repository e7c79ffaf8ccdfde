"""Spatial partitioning in the port (tpuseg_torch/parallel/halo.py and the
``spatial`` axis of tpuseg_torch/parallel/mesh.py) on the CPU, over gloo
child processes. Counterpart of tests/test_parallel.py's spatial step.

- the halo exchange alone, at spatial 2 and 4, shapes drawn from a numpy
  seed: the exchanged rows equal the neighbours' exactly, the global edges
  are zeros, and a 3x3 conv over the shards equals the unsharded conv, in
  its output and its input gradient within fp32 atol 1e-6, and in its
  weight gradient (the ranks' partial sums added: another summation order
  over up to 216 products of order 1) within atol 1e-6 + rtol 1e-5;
- one process on the global batch against ``(data, spatial) = (1, 2)`` and
  ``(2, 2)`` meshes (base 4, 64^2, a global batch of 4 over 2 steps, so a
  rank's 32 rows stay a multiple of 16), on the raw and the host paths,
  augmentation and dropout on, every rank's state bit-equal, with
  tests/test_torch_parallel.py's tolerances. In float32 the forward: the
  first step's loss rtol 1e-5 and accuracy atol 1e-6, its running
  statistics atol 1e-5, and an eval step before training likewise. In
  float64 (``*_f64``: the model, BatchNorm and the loss) the whole
  training: every loss rtol 1e-5, the first step's gradients within 1e-3 of
  each tensor's largest, the parameters after it 99.99% within 2e-5 and all
  within lr/4, the running statistics atol 1e-5. Why float64: in float32 a
  multi-rank run's BatchNorm sums, added in another order, differ from one
  process's in their last bits, and that flips discrete decisions of the
  backward: which of two near-tied values (a ReLU zero and a value just
  above it, after BatchNorm) a max pool routes the gradient to, or the side
  of zero a pre-activation falls on. Measured on these batches, the host
  path's first-step gradients differ from one process's by up to 3.4e-2 of
  a tensor's largest on the (1, 2) mesh and on the data-parallel (2, 1)
  mesh alike, and by 1.7e-2 on the (2, 2) and the (4, 1) meshes with
  average pooling; the two meshes of a pair agree to 1.3e-5;
- the port's ``(2, 2)`` step against the JAX package's ``make_mesh(data=4,
  spatial=2)`` step on its 8-device CPU mesh, the same flax weights through
  the bridge, float32, dropout off and average pooling in both (no max
  pool route to flip): the tolerances of tests/test_torch_steps.py;
- a height the JAX package takes and the port refuses.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3

HALO_CHILD = textwrap.dedent("""
    import sys

    if __name__ == "__main__":
        rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
        import os
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        import numpy as np
        import torch
        import torch.nn.functional as F
        torch.set_num_threads(1)
        from tpuseg_torch.parallel import distributed, mesh as mesh_lib
        from tpuseg_torch.parallel.halo import pad_rows_reference
        distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                           backend="gloo", timeout_s=120)
        mesh = mesh_lib.make_mesh("cpu", spatial=world)
        data = np.load(f"{work}/halo.npz")
        x, w, b, gy = (torch.from_numpy(data[k]) for k in ("x", "w", "b", "gy"))
        h = x.shape[2] // world
        rows = slice(rank * h, (rank + 1) * h)
        shards = [x[:, :, r * h:(r + 1) * h].contiguous(memory_format=torch.channels_last)
                  for r in range(world)]
        xl = shards[rank].clone().requires_grad_()
        wl = w.clone().requires_grad_()
        padded = mesh.halo(xl)
        y = F.conv2d(padded, wl, b, padding=(0, 1))
        (y * gy[:, :, rows]).sum().backward()
        torch.save({"padded": padded.detach(), "want_padded": pad_rows_reference(shards)[rank],
                    "y": y.detach(), "gx": xl.grad, "gw": wl.grad,
                    "channels_last": padded.is_contiguous(memory_format=torch.channels_last),
                    "exchanges": mesh.halo.exchanges, "route": mesh.halo.route},
                   f"{work}/halo_{world}_{rank}.pt")
        distributed.shutdown_distributed()
""")


STEP_CHILD = textwrap.dedent("""
    import sys

    if __name__ == "__main__":
        rank, world, spatial, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                                            int(sys.argv[3]), sys.argv[4], sys.argv[5])
        modes = sys.argv[6].split(",")
        import os
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        import numpy as np
        import torch
        import torch.nn.functional as F
        torch.set_num_threads(1)
        from tpuseg_torch.parallel import distributed, mesh as mesh_lib
        if world > 1:
            distributed.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                               backend="gloo", timeout_s=120)
        from tpuseg_torch.models import unet
        from tpuseg_torch.train.steps import create_train_state
        import torch.distributed.nn.functional as dnn

        mesh = mesh_lib.make_mesh("cpu", spatial=spatial)
        mesh_lib.warm_collectives(mesh)
        data = np.load(f"{work}/data.npz")
        per = data["img"].shape[1] // mesh.data
        shard = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        # float64 runs: .float() keeps float64 (BatchNorm's and the logits'
        # promotion to float32)
        to_float = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: (t if t.dtype == torch.float64
                                                 else to_float(t, *a, **k))
        real_all_reduce, max_pool = dnn.all_reduce, unet._pool
        for mode in modes:
            path, _, variant = mode.partition("_")
            unet._pool = (lambda x: F.avg_pool2d(x, 2)) if variant == "avg" else max_pool
            state = create_train_state(unet.UNet(2, 1, 4, "float32"), 0, 1e-3, "cpu")  # LR
            if variant == "f64":
                state.model.double()
                state.model.dtype = torch.float64
            if path == "jax":
                state.model.load_state_dict(torch.load(f"{work}/init.pt", weights_only=True))
                state.model.dropout_rate = 0.0
            if rank == 1:  # replicate_state must make it rank 0's
                with torch.no_grad():
                    for p in state.model.parameters():
                        p.add_(1.0)
            mesh_lib.replicate_state(state, mesh)
            if path == "raw":
                tstep, estep = mesh_lib.make_parallel_raw_steps(state.model, mesh, 2)
                xs, ys = data["img"], data["msk"]
            else:
                tstep, estep = mesh_lib.make_parallel_steps(state.model, mesh)
                xs, ys = data["x"], data["y"]
            batch = lambda step: (torch.from_numpy(xs[step, shard]),
                                  torch.from_numpy(ys[step, shard]))
            m = estep(state, *batch(0))
            out = {"loss": [], "acc": [], "eval": [m["loss"].item(), m["accuracy"].item()]}
            calls = []
            dnn.all_reduce = lambda *a, **k: calls.append(1) or real_all_reduce(*a, **k)
            sent = mesh.halo.exchanges if mesh.halo else 0
            for step in range(xs.shape[0]):
                m = tstep(state, *batch(step))
                out["loss"].append(m["loss"].item())
                out["acc"].append(m["accuracy"].item())
                if step == 0:
                    dnn.all_reduce = real_all_reduce
                    out["bn_allreduces_step0"] = len(calls)
                    out["exchanges_step0"] = (mesh.halo.exchanges if mesh.halo else 0) - sent
                    out["state_dict_step0"] = {k: v.clone() for k, v in
                                               state.model.state_dict().items()}
                    out["grads_step0"] = {k: p.grad.clone() for k, p in
                                          state.model.named_parameters()}
            out["state_dict"] = {k: v.clone() for k, v in state.model.state_dict().items()}
            torch.save(out, f"{work}/out_{mode}_{world}_{spatial}_{rank}.pt")
        distributed.shutdown_distributed()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))


def _launch(script, args_by_rank):
    """Start one child per argument list; wait for all; fail on an exit
    other than 0."""
    procs = [subprocess.Popen([sys.executable, script, *map(str, args)], cwd=str(REPO),
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args in args_by_rank]
    try:
        for p in procs:
            _, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.mark.parametrize("spatial", [2, 4])
def test_halo_exchange_matches_the_unsharded_conv(tmp_path, spatial):
    rng = np.random.default_rng(spatial)
    n, cin, cout = 2, int(rng.integers(2, 5)), 3
    h, w = int(rng.integers(1, 4)), int(rng.integers(3, 10))
    x = rng.normal(0, 1, (n, cin, h * spatial, w)).astype(np.float32)
    wt = rng.normal(0, 0.3, (cout, cin, 3, 3)).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    gy = rng.normal(0, 1, (n, cout, h * spatial, w)).astype(np.float32)
    np.savez(tmp_path / "halo.npz", x=x, w=wt, b=b, gy=gy)
    script = str(tmp_path / "child.py")
    Path(script).write_text(HALO_CHILD)
    port = _free_port()
    _launch(script, [(r, spatial, port, tmp_path) for r in range(spatial)])
    ranks = [torch.load(tmp_path / f"halo_{spatial}_{r}.pt") for r in range(spatial)]

    xt = torch.from_numpy(x).requires_grad_()
    wtt = torch.from_numpy(wt).requires_grad_()
    want = torch.nn.functional.conv2d(xt, wtt, torch.from_numpy(b), padding=1)
    (want * torch.from_numpy(gy)).sum().backward()
    for r, got in enumerate(ranks):
        assert torch.equal(got["padded"], got["want_padded"]), r
        assert got["channels_last"] and got["route"] == "gloo"
        # one forward and one backward exchange
        assert got["exchanges"] == 2
        if r == 0:
            assert not got["padded"][:, :, 0].any()
        if r == spatial - 1:
            assert not got["padded"][:, :, -1].any()
    torch.testing.assert_close(torch.cat([g["y"] for g in ranks], 2), want.detach(),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(torch.cat([g["gx"] for g in ranks], 2), xt.grad,
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(sum(g["gw"] for g in ranks), wtt.grad, atol=1e-6, rtol=1e-5)


def _data(work, seed=7, steps=2, batch=4, size=64):
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


MODES = "raw,host,raw_f64,host_f64"
MESHES = {"one": (1, 1, MODES), "1x2": (2, 2, MODES), "2x2": (4, 2, MODES + ",jax_avg")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, a (1, 2) mesh and a (2, 2) mesh, all at once, each
    child running its modes in turn; and the flax weights of the "jax"
    mode, whose JAX step the test runs."""
    import jax

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.models.unet import init_variables
    from tpuseg_torch.utils.jax_bridge import flax_to_state_dict

    work = tmp_path_factory.mktemp("spatial")
    x, y = _data(str(work))
    import jax.numpy as jnp

    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, init_variables(model, jax.random.PRNGKey(3), num_channels=1))
    torch.save(flax_to_state_dict(variables), work / "init.pt")
    script = str(work / "child.py")
    Path(script).write_text(STEP_CHILD)
    ports = {name: _free_port() for name in MESHES}
    _launch(script, [(r, world, spatial, ports[name], work, modes)
                     for name, (world, spatial, modes) in MESHES.items()
                     for r in range(world)])

    def load(name, mode):
        world, spatial, _ = MESHES[name]
        return [torch.load(work / f"out_{mode}_{world}_{spatial}_{r}.pt", weights_only=False)
                for r in range(world)]

    return {"load": load, "model": model, "variables": variables, "x": x, "y": y}


def _assert_same_ranks(ranks):
    a = ranks[0]
    for b in ranks[1:]:
        for k in a["state_dict"]:
            assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
        assert a["loss"] == b["loss"] and a["acc"] == b["acc"] and a["eval"] == b["eval"]


def _assert_forward_close(got, one):
    np.testing.assert_allclose(got["loss"][0], one["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(got["acc"][0], one["acc"][0], atol=1e-6)
    np.testing.assert_allclose(got["eval"][0], one["eval"][0], rtol=1e-5)
    np.testing.assert_allclose(got["eval"][1], one["eval"][1], atol=1e-6)
    for k, v in one["state_dict_step0"].items():
        if "running" in k:
            d = (got["state_dict_step0"][k] - v).abs()
            assert d.max() <= 1e-5, (k, d.max())


def _assert_counts(got, one):
    # sync-BN over every rank; every 3x3 conv (18) exchanged forward, and
    # backward all but enc1a, whose input (the images) takes no gradient
    assert got["bn_allreduces_step0"] == 23 and one["bn_allreduces_step0"] == 0
    assert got["exchanges_step0"] == 18 + 17 and one["exchanges_step0"] == 0


@pytest.mark.parametrize("mode", ["raw", "host"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_spatial_mesh_matches_one_process_on_the_global_batch(runs, mesh, mode):
    """Dropout on, and on the raw path augmentation too: drawn for the
    global batch at the full height, so the mesh trains as one process
    (the forward in float32, the whole training in float64: module
    docstring)."""
    ranks = runs["load"](mesh, mode)
    (one,) = runs["load"]("one", mode)
    _assert_same_ranks(ranks)
    got = ranks[0]
    _assert_forward_close(got, one)
    _assert_counts(got, one)

    ranks = runs["load"](mesh, mode + "_f64")
    (one,) = runs["load"]("one", mode + "_f64")
    _assert_same_ranks(ranks)
    got = ranks[0]
    _assert_forward_close(got, one)
    _assert_counts(got, one)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], one["acc"], atol=1e-6)
    for k, g in one["grads_step0"].items():
        err = (got["grads_step0"][k] - g).abs().max() / g.abs().max()
        assert err < 1e-3, (k, err)
    n = n_ok = 0
    for k, v in one["state_dict_step0"].items():
        d = (got["state_dict_step0"][k] - v).abs()
        if "running" not in k and "num_batches" not in k:
            n += d.numel()
            n_ok += int((d <= 2e-5).sum())
            assert d.max() <= LR / 4, (k, d.max())
    assert n_ok / n >= 0.9999
    for k, v in one["state_dict"].items():
        if "running" in k:
            np.testing.assert_allclose(got["state_dict"][k].numpy(), v.numpy(), atol=1e-5,
                                       rtol=0, err_msg=k)


def test_spatial_mesh_matches_jax_spatial_mesh_step(runs, monkeypatch):
    """The port's (2, 2) mesh against the JAX package's (4, 2) mesh on its
    8-device CPU mesh: the same flax weights and global batch, dropout off
    and average pooling in both."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from tpuseg.models import unet as junet
    from tpuseg.parallel import mesh as jmesh
    from tpuseg.train import steps as jsteps
    from tpuseg_torch.models.unet import UNet

    from test_torch_steps import LR as STEPS_LR
    from test_torch_steps import _assert_state_close

    monkeypatch.setattr(nn.Dropout, "__call__", lambda self, x, *a, **k: x)
    monkeypatch.setattr(junet, "_pool", lambda x: nn.avg_pool(x, (2, 2), strides=(2, 2)))
    model, variables, x, y = runs["model"], runs["variables"], runs["x"], runs["y"]
    mesh = jmesh.make_mesh(data=4, spatial=2)
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

    got = runs["load"]("2x2", "jax_avg")
    _assert_same_ranks(got)
    np.testing.assert_allclose(got[0]["loss"], [w[0] for w in want], rtol=1e-5)
    np.testing.assert_allclose(got[0]["acc"], [w[1] for w in want], atol=1e-6)
    port = UNet(2, 1, 4, "float32")
    port.load_state_dict(got[0]["state_dict"])
    _assert_state_close(jax.tree_util.tree_map(np.asarray, jstate), port)


def test_port_refuses_heights_the_jax_package_takes():
    """48 rows over 2 ranks: the JAX package's rules hold (a multiple of 16
    that divides by 2), but a rank's 24 rows would split a pool window."""
    from tpuseg_torch.parallel.halo import check_height, local_rows
    from tpuseg_torch import SIZE_FACTOR

    assert 48 % SIZE_FACTOR == 0 and 48 % 2 == 0
    for call in (lambda: check_height(48, 2), lambda: local_rows(torch.zeros(1, 48, 16, 1),
                                                                (0, 2))):
        with pytest.raises(ValueError, match=r"multiple of 16 and divide by spatial=2.*"
                                             r"multiple of 16\*2 = 32"):
            call()
    check_height(64, 2)
    check_height(48, 1)
