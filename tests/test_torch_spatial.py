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
  ``(2, 2)`` meshes (base 4, 64^2, a global batch of 4 over 2 steps; a
  rank's 32 rows keep every pool on one rank), on the raw and the host paths,
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
  the bridge, dropout off and average pooling in both (no max pool route
  to flip), with the tolerances of tests/test_torch_steps.py (every weight
  within lr/4 among them): the first step's loss and accuracy in float32;
  the state after the first step, of the (2, 2) mesh in float64 and of one
  process in float32; in float64 the first loss against JAX, and the whole
  training against the port's one process as above. In float32 neither
  package holds the later steps, nor the (2, 2) mesh's state to lr/4: on
  the 64-row batches JAX's own (4, 2) mesh and its one-device jitted step
  part by 3.0e-5 in the second step's loss and by 2.0 lr in a weight after
  the first step (a gradient near zero whose sign flips; jax 0.9.0), the
  port's one process and the one-device step by 3.0e-5 and 2.0 lr, while
  the port's one process and JAX's mesh agree to 1.7e-7 and 0.0027 lr
  (``PYTHONPATH=.:tests python tests/test_torch_spatial.py`` measures
  these). After the first step the port's (2, 2) mesh parts from JAX's
  mesh by 1.96 lr (``enc2a.conv.weight``) in float32 and by 0.0022 lr in
  float64, at 48 rows by 0.0049 and 0.0033 lr (``-s`` prints the float32
  gap);
- heights whose pool windows straddle two ranks (``halo.split_level``):
  the row gather alone at spatial 2 and 4 against ``gather_rows_reference``
  (its forward exact, its backward, a sum over the ranks, within fp32 atol
  1e-6); 48 x 32 images on the (1, 2) mesh (rows gathered at level 3) and
  the (1, 4) mesh (level 2) against one process, with the tolerances
  above, max pooling in f64; the (2, 2) mesh at 48 rows against JAX's (4,
  2) mesh as at 64;
- the heights the JAX package refuses (not a multiple of 16, or not of
  the spatial size) raise ``ValueError`` in both packages.
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

HALO_CHILD = textwrap.dedent("""
    import sys

    if __name__ == "__main__":
        rank, world, rdzv, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
        import os
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        import numpy as np
        import torch
        import torch.nn.functional as F
        torch.set_num_threads(1)
        from tpuseg_torch.parallel import distributed, mesh as mesh_lib
        from tpuseg_torch.parallel.halo import gather_rows_reference, pad_rows_reference
        distributed.initialize_distributed(rdzv, world, rank, backend="gloo", timeout_s=120)
        mesh = mesh_lib.make_mesh("cpu", spatial=world)
        data = np.load(f"{work}/halo.npz")
        x, w, b, gy, gz = (torch.from_numpy(data[k]) for k in ("x", "w", "b", "gy", "gz"))
        h = x.shape[2] // world
        rows = slice(rank * h, (rank + 1) * h)
        shards = [x[:, :, r * h:(r + 1) * h].contiguous(memory_format=torch.channels_last)
                  for r in range(world)]
        xl = shards[rank].clone().requires_grad_()
        wl = w.clone().requires_grad_()
        padded = mesh.halo(xl)
        y = F.conv2d(padded, wl, b, padding=(0, 1))
        (y * gy[:, :, rows]).sum().backward()
        xg = shards[rank].clone().requires_grad_()
        full = mesh.halo.gather(xg)
        (full * gz[rank]).sum().backward()
        torch.save({"padded": padded.detach(), "want_padded": pad_rows_reference(shards)[rank],
                    "y": y.detach(), "gx": xl.grad, "gw": wl.grad,
                    "channels_last": padded.is_contiguous(memory_format=torch.channels_last),
                    "exchanges": mesh.halo.exchanges, "route": mesh.halo.route,
                    "full": full.detach(), "want_full": gather_rows_reference(shards)[rank],
                    "full_channels_last": full.is_contiguous(memory_format=torch.channels_last),
                    "g_shard": xg.grad, "gathers": mesh.halo.gathers,
                    "gather_bytes": mesh.halo.gather_bytes},
                   f"{work}/halo_{world}_{rank}.pt")
        # every rank's last collective done before any tears down its
        # pairs (else a rank now and then aborts at exit)
        if torch.distributed.is_initialized():
            torch.distributed.barrier()
        distributed.shutdown_distributed()
""")


STEP_CHILD = textwrap.dedent("""
    import sys

    if __name__ == "__main__":
        rank, world, spatial, rdzv, work = (int(sys.argv[1]), int(sys.argv[2]),
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
            distributed.initialize_distributed(rdzv, world, rank, backend="gloo",
                                               timeout_s=120)
        from tpuseg_torch.models import unet
        from tpuseg_torch.train.steps import create_train_state
        import torch.distributed.nn.functional as dnn

        mesh = mesh_lib.make_mesh("cpu", spatial=spatial)
        mesh_lib.warm_collectives(mesh)
        # float64 runs: .float() keeps float64 (BatchNorm's and the logits'
        # promotion to float32)
        to_float = torch.Tensor.float
        torch.Tensor.float = lambda t, *a, **k: (t if t.dtype == torch.float64
                                                 else to_float(t, *a, **k))
        real_all_reduce, max_pool = dnn.all_reduce, unet._pool
        for mode in modes:
            # "mode@tag": the batches of data{tag}.npz
            path, _, variant = mode.partition("@")[0].partition("_")
            data = np.load(f"{work}/data{mode.partition('@')[2]}.npz")
            per = data["img"].shape[1] // mesh.data
            shard = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
            variant = variant.split("_")
            unet._pool = (lambda x: F.avg_pool2d(x, 2)) if "avg" in variant else max_pool
            state = create_train_state(unet.UNet(2, 1, 4, "float32"), 0, 1e-3, "cpu")  # LR
            if "f64" in variant:
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
            gathered = mesh.halo.gathers if mesh.halo else 0
            for step in range(xs.shape[0]):
                m = tstep(state, *batch(step))
                out["loss"].append(m["loss"].item())
                out["acc"].append(m["accuracy"].item())
                if step == 0:
                    dnn.all_reduce = real_all_reduce
                    out["bn_allreduces_step0"] = len(calls)
                    out["exchanges_step0"] = (mesh.halo.exchanges if mesh.halo else 0) - sent
                    out["gathers_step0"] = (mesh.halo.gathers if mesh.halo else 0) - gathered
                    out["state_dict_step0"] = {k: v.clone() for k, v in
                                               state.model.state_dict().items()}
                    out["grads_step0"] = {k: p.grad.clone() for k, p in
                                          state.model.named_parameters()}
            out["state_dict"] = {k: v.clone() for k, v in state.model.state_dict().items()}
            torch.save(out, f"{work}/out_{mode}_{world}_{spatial}_{rank}.pt")
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


@pytest.fixture(scope="module")
def halo_runs(tmp_path_factory):
    """The exchange and the gather at spatial 2 and 4, all ranks at once;
    spatial -> (the inputs, each rank's results)."""
    work = tmp_path_factory.mktemp("halo")
    script = str(work / "child.py")
    Path(script).write_text(HALO_CHILD)
    runs = {}
    for spatial in (2, 4):
        rng = np.random.default_rng(spatial)
        n, cin, cout = 2, int(rng.integers(2, 5)), 3
        h, w = int(rng.integers(1, 4)), int(rng.integers(3, 10))
        x = rng.normal(0, 1, (n, cin, h * spatial, w)).astype(np.float32)
        wt = rng.normal(0, 0.3, (cout, cin, 3, 3)).astype(np.float32)
        b = rng.normal(0, 0.1, cout).astype(np.float32)
        gy = rng.normal(0, 1, (n, cout, h * spatial, w)).astype(np.float32)
        # each rank's upstream gradient of the gathered rows
        gz = rng.normal(0, 1, (spatial, *x.shape)).astype(np.float32)
        (work / str(spatial)).mkdir()
        np.savez(work / str(spatial) / "halo.npz", x=x, w=wt, b=b, gy=gy, gz=gz)
        runs[spatial] = dict(x=x, w=wt, b=b, gy=gy, gz=gz)
    rdzv = {spatial: _rendezvous(work) for spatial in runs}
    _launch(script, [(r, spatial, rdzv[spatial], work / str(spatial))
                     for spatial in runs for r in range(spatial)])
    return {spatial: (data, [torch.load(work / str(spatial) / f"halo_{spatial}_{r}.pt")
                             for r in range(spatial)])
            for spatial, data in runs.items()}


@pytest.mark.parametrize("spatial", [2, 4])
def test_halo_exchange_matches_the_unsharded_conv(halo_runs, spatial):
    data, ranks = halo_runs[spatial]
    xt = torch.from_numpy(data["x"]).requires_grad_()
    wtt = torch.from_numpy(data["w"]).requires_grad_()
    want = torch.nn.functional.conv2d(xt, wtt, torch.from_numpy(data["b"]), padding=1)
    (want * torch.from_numpy(data["gy"])).sum().backward()
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


@pytest.mark.parametrize("spatial", [2, 4])
def test_row_gather_matches_one_process(halo_runs, spatial):
    """Every rank holds the full height after the gather; a shard's gradient
    is every rank's upstream gradient at its rows, summed."""
    from tpuseg_torch.parallel.halo import gather_rows_reference

    data, ranks = halo_runs[spatial]
    x = torch.from_numpy(data["x"])
    h = x.shape[2] // spatial
    shards = [x[:, :, r * h:(r + 1) * h].clone().requires_grad_() for r in range(spatial)]
    want = gather_rows_reference(shards)
    sum((w * torch.from_numpy(g)).sum() for w, g in zip(want, data["gz"])).backward()
    for r, got in enumerate(ranks):
        assert torch.equal(got["full"], x) and torch.equal(got["want_full"], x), r
        assert got["full_channels_last"]
        torch.testing.assert_close(got["g_shard"], shards[r].grad, atol=1e-6, rtol=0)
        # one gather forward (this rank's rows) and one all-reduce backward
        # (the full height)
        assert got["gathers"] == 2
        assert got["gather_bytes"] == 4 * (x.numel() // spatial + x.numel())


def _data(work, seed=7, steps=2, batch=4, size=(64, 64), tag=""):
    """``steps`` raw global batches (uint16-range images, uint8 masks) and
    as many preprocessed ones (z-scored images, one-hot labels), saved as
    ``data{tag}.npz``."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 4000, (steps, batch, *size, 1)).astype(np.int32)
    msk = (img[..., 0] + rng.normal(0, 600, img.shape[:4]) > 2000).astype(np.uint8)
    x = rng.normal(0, 1, (steps, batch, *size, 1)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x[..., 0] + rng.normal(0, 0.5, x.shape[:4]) > 0)
                                    .astype(np.int32)]
    np.savez(os.path.join(work, f"data{tag}.npz"), img=img, msk=msk, x=x, y=y)
    return x, y


MODES = "raw,host,raw_f64,host_f64"
# 48 x 32 images: a pool window straddles two ranks at spatial 2 and 4
STRADDLE = "@48"
MODES_48 = ",".join(m + STRADDLE for m in MODES.split(","))
# the JAX comparison's weights and average pooling, in float32 and float64
JAX_MODES = "jax_avg,jax_avg_f64,jax_avg" + STRADDLE + ",jax_avg_f64" + STRADDLE
MESHES = {"one": (1, 1, MODES + "," + MODES_48 + "," + JAX_MODES),
          "1x2": (2, 2, MODES + "," + MODES_48), "1x4": (4, 4, MODES_48),
          "2x2": (4, 2, MODES + "," + JAX_MODES)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, a (1, 2), a (1, 4) and a (2, 2) mesh, all at once,
    each child running its modes in turn; and the flax weights of the "jax"
    mode, whose JAX step the test runs."""
    import jax

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.models.unet import init_variables
    from tpuseg_torch.utils.jax_bridge import flax_to_state_dict

    work = tmp_path_factory.mktemp("spatial")
    batches = {"": _data(str(work)),
               STRADDLE: _data(str(work), seed=8, size=(48, 32), tag=STRADDLE[1:])}
    import jax.numpy as jnp

    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, init_variables(model, jax.random.PRNGKey(3), num_channels=1))
    torch.save(flax_to_state_dict(variables), work / "init.pt")
    script = str(work / "child.py")
    Path(script).write_text(STEP_CHILD)
    rdzv = {name: _rendezvous(work) for name in MESHES}
    _launch(script, [(r, world, spatial, rdzv[name], work, modes)
                     for name, (world, spatial, modes) in MESHES.items()
                     for r in range(world)])

    def load(name, mode):
        world, spatial, _ = MESHES[name]
        return [torch.load(work / f"out_{mode}_{world}_{spatial}_{r}.pt", weights_only=False)
                for r in range(world)]

    return {"load": load, "model": model, "variables": variables, "batches": batches}


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


def _assert_counts(got, one, level=None):
    """sync-BN over every rank; every 3x3 conv of the row-sharded levels
    (all 18, or the 4 of each level down to the gathered ``level``)
    exchanged forward, and backward all but enc1a, whose input (the images)
    takes no gradient; with a ``level``, one gather forward and one
    backward."""
    convs = 18 if level is None else 4 * (level + 1)
    assert got["bn_allreduces_step0"] == 23 and one["bn_allreduces_step0"] == 0
    assert got["exchanges_step0"] == 2 * convs - 1 and one["exchanges_step0"] == 0
    assert got["gathers_step0"] == (0 if level is None else 2)
    assert one["gathers_step0"] == 0


def _assert_mesh_matches_one_process(runs, mesh, mode, level=None):
    """The forward in float32, the whole training in float64 (module
    docstring)."""
    ranks = runs["load"](mesh, mode)
    (one,) = runs["load"]("one", mode)
    _assert_same_ranks(ranks)
    got = ranks[0]
    _assert_forward_close(got, one)
    _assert_counts(got, one, level)

    path, _, tag = mode.partition("@")
    ranks = runs["load"](mesh, f"{path}_f64@{tag}" if tag else path + "_f64")
    (one,) = runs["load"]("one", f"{path}_f64@{tag}" if tag else path + "_f64")
    _assert_same_ranks(ranks)
    got = ranks[0]
    _assert_forward_close(got, one)
    _assert_counts(got, one, level)
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["acc"], one["acc"], atol=1e-6)
    errs = {}
    for k, g in one["grads_step0"].items():
        errs[k] = ((got["grads_step0"][k] - g).abs().max() / g.abs().max()).item()
        assert errs[k] < 1e-3, (k, errs[k])
    print(f"{mesh} {mode}: first-step gradient error at most {max(errs.values()):.1e} of "
          f"a tensor's largest")
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


@pytest.mark.parametrize("mode", ["raw", "host"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_spatial_mesh_matches_one_process_on_the_global_batch(runs, mesh, mode):
    """Dropout on, and on the raw path augmentation too: drawn for the
    global batch at the full height, so the mesh trains as one process
    (the forward in float32, the whole training in float64: module
    docstring)."""
    _assert_mesh_matches_one_process(runs, mesh, mode)


@pytest.mark.parametrize("mode", ["raw", "host"])
@pytest.mark.parametrize("mesh, level", [("1x2", 3), ("1x4", 2)])
def test_spatial_mesh_matches_one_process_where_pools_straddle_ranks(runs, mesh, level,
                                                                     mode):
    """48 rows: a rank holds 24, 12, 6, 3 rows at spatial 2 and 12, 6, 3 at
    spatial 4, so the rows are gathered before the pool that leaves level
    3 (spatial 2) or 2 (spatial 4); dropout, augmentation and max pooling
    on, the module docstring's tolerances."""
    _assert_mesh_matches_one_process(runs, mesh, mode + STRADDLE, level)


def _largest_weight_gap(jstate, state_dict):
    """The largest gap between a parameter of ``state_dict`` and JAX's."""
    from tpuseg_torch.utils.jax_bridge import flax_to_state_dict

    want = flax_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    return max((state_dict[k].double() - v.double()).abs().max().item()
               for k, v in want.items() if "running" not in k and "num_batches" not in k)


def _assert_matches_jax_spatial_mesh(runs, monkeypatch, tag, level=None):
    """The port's (2, 2) mesh against the JAX package's (4, 2) mesh on its
    8-device CPU mesh, on the batches of ``data{tag}.npz``: the same flax
    weights and global batch, dropout off and average pooling in both. The
    first step against JAX (its loss in float32, the state after it in
    float64 and, on one process, in float32); every step in float64
    against the port's one process (module docstring)."""
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
    model, variables = runs["model"], runs["variables"]
    x, y = runs["batches"][tag]
    mesh = jmesh.make_mesh(data=4, spatial=2)
    assert STEPS_LR == LR
    jstate = jsteps.create_train_state(model, jax.random.PRNGKey(0), 1, LR)
    jstate = jmesh.replicate_state(
        jstate.replace(params=variables["params"], batch_stats=variables["batch_stats"]), mesh)
    tstep, _ = jmesh.make_parallel_steps(model, mesh)
    jstate, m = tstep(jstate, *jmesh.shard_batch(mesh, jnp.asarray(x[0]), jnp.asarray(y[0])))

    got = runs["load"]("2x2", "jax_avg" + tag)
    _assert_same_ranks(got)
    np.testing.assert_allclose(got[0]["loss"][0], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got[0]["acc"][0], float(m["accuracy"]), atol=1e-6)
    jstate = jax.tree_util.tree_map(np.array, jstate)
    port = UNet(2, 1, 4, "float32")
    print(f"(2, 2) float32 against JAX's mesh after the first step: largest weight gap "
          f"{_largest_weight_gap(jstate, got[0]['state_dict_step0']) / LR:.3g} lr")
    # the state after the first step with every tolerance: the (2, 2) mesh
    # in float64, one process in float32 (module docstring)
    for name, mode in (("2x2", "jax_avg_f64"), ("one", "jax_avg")):
        port.load_state_dict(runs["load"](name, mode + tag)[0]["state_dict_step0"])
        _assert_state_close(jstate, port)
    (f64,) = runs["load"]("one", "jax_avg_f64" + tag)
    np.testing.assert_allclose(f64["loss"][0], float(m["loss"]), rtol=1e-5)
    _assert_mesh_matches_one_process(runs, "2x2", "jax_avg" + tag, level)
    return got[0]


def test_spatial_mesh_matches_jax_spatial_mesh_step(runs, monkeypatch):
    """At 64 rows: every pool stays on one rank."""
    assert _assert_matches_jax_spatial_mesh(runs, monkeypatch, "")["gathers_step0"] == 0


def test_spatial_mesh_matches_jax_spatial_mesh_step_where_pools_straddle_ranks(
        runs, monkeypatch):
    """At 48 rows the port gathers level 3's rows (24, 12, 6, 3 a rank);
    GSPMD splits the fourth pool's window between two devices."""
    got = _assert_matches_jax_spatial_mesh(runs, monkeypatch, STRADDLE, level=3)
    assert got["gathers_step0"] == 2


@pytest.mark.parametrize("height, spatial, level", [
    (48, 2, 3), (32, 4, 3), (528, 2, 3), (48, 4, 2), (16, 8, 1), (16, 16, 0),
    (64, 2, None), (512, 8, None), (48, 1, None)])
def test_split_level(height, spatial, level):
    """The level whose rows are gathered: the first (0-3) where a rank's
    rows are odd; the port takes the height and each rank its share."""
    from tpuseg_torch.parallel.halo import check_height, local_rows, split_level

    assert split_level(height, spatial) == level
    check_height(height, spatial)
    t = torch.arange(height).reshape(1, height, 1, 1).expand(2, height, 16, 1)
    h = height // spatial
    for r in range(spatial):
        assert torch.equal(local_rows(t, (r, spatial)), t[:, r * h:(r + 1) * h])


@pytest.mark.parametrize("height, spatial", [(40, 2), (64, 3), (24, 4)])
def test_heights_the_jax_package_refuses_raise_in_both_packages(height, spatial):
    """Not a multiple of 16 (40, 24) or not of the spatial size (64 over
    3): the JAX package refuses to shard the batch or to run the model on
    it, and the port's rule, its row split and its model raise alike."""
    import types

    import jax
    import jax.numpy as jnp

    from tpuseg.models.unet import UNet as JaxUNet
    from tpuseg.models.unet import init_variables
    from tpuseg.parallel import mesh as jmesh
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.parallel.halo import check_height, local_rows, split_level

    model = JaxUNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = init_variables(model, jax.random.PRNGKey(0), num_channels=1)
    mesh = jmesh.make_mesh(devices=jax.devices()[:spatial], data=1, spatial=spatial)
    x = np.zeros((1, height, 32, 1), np.float32)
    with pytest.raises(ValueError):
        xs, _ = jmesh.shard_batch(mesh, x, np.zeros((1, height, 32, 2), np.float32))
        model.apply(variables, xs)

    for call in (lambda: check_height(height, spatial),
                 lambda: split_level(height, spatial),
                 lambda: local_rows(torch.from_numpy(x), (0, spatial))):
        with pytest.raises(ValueError, match=rf"image height {height} cannot be partitioned "
                                             rf"over spatial={spatial}: the height must be a "
                                             rf"multiple of 16 and divide by spatial"):
            call()
    if height % spatial == 0:
        port = UNet(2, 1, 4, "float32").eval()
        port.halo = types.SimpleNamespace(size=spatial, rank=0)
        with pytest.raises(ValueError, match=f"got H={height}"):
            port(torch.zeros(1, height // spatial, 32, 1))


if __name__ == "__main__":
    # measures the second-step gaps quoted in the module docstring:
    #   PYTHONPATH=.:tests python tests/test_torch_spatial.py
    import tempfile

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    import torch.nn.functional as F

    jax.config.update("jax_platforms", "cpu")
    from tpuseg.models import unet as junet
    from tpuseg.parallel import mesh as jmesh
    from tpuseg.train import steps as jsteps
    from tpuseg_torch.models import unet
    from tpuseg_torch.train.steps import create_train_state, train_step
    from tpuseg_torch.utils.jax_bridge import flax_to_state_dict

    nn.Dropout.__call__ = lambda self, x, *a, **k: x
    junet._pool = lambda x: nn.avg_pool(x, (2, 2), strides=(2, 2))
    unet._pool = lambda x: F.avg_pool2d(x, 2)
    torch.set_num_threads(1)
    work = tempfile.mkdtemp()
    model = junet.UNet(num_classes=2, base_features=4, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, junet.init_variables(model, jax.random.PRNGKey(3), num_channels=1))
    tx = jsteps.make_optimizer()
    for tag, kw in (("64 rows", {}), ("48 rows", dict(seed=8, size=(48, 32), tag="48"))):
        x, y = _data(work, **kw)

        def fresh():
            s = jsteps.create_train_state(model, jax.random.PRNGKey(0), 1, LR)
            return s.replace(params=variables["params"], batch_stats=variables["batch_stats"])

        one_device = jax.jit(lambda s, a, b: jsteps.train_step(model, tx, s, a, b))
        mesh = jmesh.make_mesh(data=4, spatial=2)
        mesh_step, _ = jmesh.make_parallel_steps(model, mesh)
        port = create_train_state(unet.UNet(2, 1, 4, "float32"), 0, LR, "cpu")
        port.model.load_state_dict(flax_to_state_dict(variables))
        port.model.dropout_rate = 0.0
        s1, s2, losses, moved = fresh(), jmesh.replicate_state(fresh(), mesh), [], []

        def params(p):
            return {k: v.numpy() for k, v in flax_to_state_dict(
                {"params": jax.tree_util.tree_map(np.array, p),
                 "batch_stats": variables["batch_stats"]}).items() if "running" not in k}

        for k in range(x.shape[0]):
            s1, m1 = one_device(s1, jnp.asarray(x[k]), jnp.asarray(y[k]))
            s2, m2 = mesh_step(s2, *jmesh.shard_batch(mesh, jnp.asarray(x[k]),
                                                        jnp.asarray(y[k])))
            m3 = train_step(port, torch.from_numpy(x[k]), torch.from_numpy(y[k]))
            losses.append((float(m1["loss"]), float(m2["loss"]), m3["loss"].item()))
            p1, p2 = params(s1.params), params(s2.params)
            p3 = {k: v.detach().numpy() for k, v in port.model.state_dict().items() if k in p1}
            # the largest parameter gap, in units of lr
            moved.append([max(np.abs(a[n] - b[n]).max() for n in p1) / LR
                          for a, b in ((p2, p1), (p3, p1), (p3, p2))])
        for k, ((a, b, c), (d12, d31, d32)) in enumerate(zip(losses, moved)):
            print(f"{tag}, step {k}: loss: JAX mesh vs one device {abs(b - a) / a:.2g}, port "
                  f"one process vs JAX one device {abs(c - a) / a:.2g}, vs JAX mesh "
                  f"{abs(c - b) / b:.2g}; largest parameter gap (lr): {d12:.2g}, {d31:.2g}, "
                  f"{d32:.2g}")
