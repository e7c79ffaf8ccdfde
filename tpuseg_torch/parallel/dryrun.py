"""A dry run of data parallelism: ``dryrun_multigpu(n)``.

Counterpart of ``__graft_entry__.dryrun_multichip`` in the JAX package. It
starts ``n`` ranks, one process each: one per GPU (NCCL) when ``n`` GPUs
are visible, else gloo ranks on the CPU. As ``dryrun_multichip`` does, an
even ``n`` makes a ``(n / 2, 2)`` mesh, each image's rows sharded over
spatial pairs with the halo exchange. Every rank runs, at base 4 on 64^2
inputs (32 rows a rank):

- one train and eval step on preprocessed batches;
- one ZeRO-1 step;
- one raw step (device augmentation, ZeRO-1), the trainer's default path;
- on a spatial mesh, one train and eval step at 48 rows (24 a rank), whose
  fourth pool window straddles the pair: the rows are gathered at the
  level ``halo.split_level`` names;

and rank 0 serves one image through the tiled engines sharded over two
shards (its GPUs, or the CPU twice) and over one, for ``none``, ``int8``
and ``int8_blocked``: the masks must be bit-equal.

    python -c "from tpuseg_torch.parallel.dryrun import dryrun_multigpu; \\
print(dryrun_multigpu(2))"
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback

import numpy as np
import torch

SIZE = 64  # input side
BATCH = 2  # per rank
STRADDLE = 48  # rows of the spatial mesh's straddling step




def _finite(x: float, what: str) -> float:
    if not np.isfinite(x) or x <= 0:
        raise AssertionError(f"{what}: loss {x}")
    return x


def _serving(model, device, devices) -> dict:
    """One 128 x 160 image tiled (tile 64, radius 16, 3 tiles a chunk)
    through each engine, sharded over ``devices`` against one shard; every
    shard has its own replica of the predict function."""
    from tpuseg_torch.infer import quant
    from tpuseg_torch.infer.tiled import inference_tiled, make_predict_fn
    from tpuseg_torch.models.unet import UNet

    def fp_replica(d):
        m = UNet(model.num_classes, model.num_channels, model.base_features, model.dtype)
        m.load_state_dict(model.state_dict())
        return make_predict_fn(m.to(d).eval())

    img = np.random.default_rng(2).integers(0, 4096, (128, 160)).astype(np.uint16)
    stats = (np.asarray([img.mean()], np.float32), np.asarray([img.std()], np.float32))
    folded = quant.fold_variables(model)
    ranges = quant.calibrate(folded, [(img[:64, :64] - stats[0][0]) / stats[1][0]],
                             device=device)
    makers = {"none": fp_replica}
    for mode, blocked in (("int8", False), ("int8_blocked", True)):
        makers[mode] = (lambda d, b=blocked: quant.make_quantized_predict_fn(
            folded, ranges, blocked_edges=b))
    out = {}
    for mode, make in makers.items():
        masks = [inference_tiled(img, [make(d) for d in devs], 64, 16, 3, 2, stats,
                                 device=device, devices=devs)
                 for devs in ([device], devices)]
        if not np.array_equal(*masks):
            raise AssertionError(f"{mode}: sharded masks differ from one shard's on "
                                 f"{int((masks[0] != masks[1]).sum())} pixels")
        out[mode] = {"shards": len(devices), "class1_share": float((masks[0] == 1).mean())}
    return out


def _straddle(mesh, device, x, shard) -> dict:
    """One train and eval step on ``x``'s first STRADDLE rows over the
    spatial mesh: the split level, the losses and the gather's calls."""
    from tpuseg_torch.models.unet import UNet
    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.parallel.halo import split_level
    from tpuseg_torch.train.steps import create_train_state

    img = torch.from_numpy(x[shard, :STRADDLE]).to(device)
    lbl = torch.nn.functional.one_hot((img[..., 0] > 0).long(), 2).float()
    state = create_train_state(UNet(2, 1, 4, "float32"), 5, 1e-3, device)
    tstep, estep = mesh_lib.make_parallel_steps(state.model, mesh, state=state)
    before = mesh.halo.gathers
    loss = _finite(tstep(state, img, lbl)["loss"].item(), "straddle")
    return {"height": STRADDLE, "split_level": split_level(STRADDLE, mesh.spatial),
            "loss": loss, "eval": _finite(estep(state, img, lbl)["loss"].item(),
                                          "straddle eval"),
            "gathers": mesh.halo.gathers - before}


def _rank_main(rank: int, world: int, rdzv: str, cuda: bool, results) -> None:
    """One rank of the dry run; puts ``(rank, result or None, error or
    None)`` on ``results``."""
    try:
        os.environ["LOCAL_RANK"] = str(rank)
        os.environ["LOCAL_WORLD_SIZE"] = str(world)
        if not cuda:
            torch.set_num_threads(1)
        from tpuseg_torch.models.unet import UNet
        from tpuseg_torch.parallel import distributed
        from tpuseg_torch.parallel import mesh as mesh_lib
        from tpuseg_torch.train.steps import create_train_state

        backend = distributed.initialize_distributed(
            rdzv, world, rank, backend="nccl" if cuda else "gloo", timeout_s=120)
        device = torch.device("cuda", rank) if cuda else torch.device("cpu")
        mesh = mesh_lib.make_mesh(device, spatial=2 if world % 2 == 0 else 1)
        mesh_lib.warm_collectives(mesh)
        rng = np.random.default_rng(1)
        x = rng.normal(0, 1, (mesh.data * BATCH, SIZE, SIZE, 1)).astype(np.float32)
        # this rank's data shard, full images: the steps keep its rows
        shard = slice(mesh.data_rank * BATCH, (mesh.data_rank + 1) * BATCH)
        img = torch.from_numpy(x[shard]).to(device)
        lbl = torch.nn.functional.one_hot((img[..., 0] > 0).long(), 2).float()
        raw = torch.from_numpy((np.abs(x[shard]) * 1000).astype(np.int32)).to(device)
        msk = (raw[..., 0] > 700).to(torch.uint8)
        res = {"backend": backend, "device": str(device), "mesh": [mesh.data, mesh.spatial],
               "halo_route": mesh.halo.route if mesh.halo else None}
        for name, zero in (("data_parallel", False), ("zero1", True)):
            state = create_train_state(UNet(2, 1, 4, "float32"), 0, 1e-3, device)
            tstep, estep = mesh_lib.make_parallel_steps(state.model, mesh,
                                                        shard_optimizer=zero, state=state)
            res[name] = _finite(tstep(state, img, lbl)["loss"].item(), name)
            res[name + "_eval"] = _finite(estep(state, img, lbl)["loss"].item(), name)
        state = create_train_state(UNet(2, 1, 4, "float32"), 4, 1e-3, device)
        tstep, estep = mesh_lib.make_parallel_raw_steps(state.model, mesh, 2, augment=True,
                                                        shard_optimizer=True, state=state)
        res["raw_zero1"] = _finite(tstep(state, raw, msk)["loss"].item(), "raw")
        res["raw_zero1_eval"] = _finite(estep(state, raw, msk)["loss"].item(), "raw eval")
        res["halo_exchanges"] = mesh.halo.exchanges if mesh.halo else 0
        if mesh.halo is not None:
            res["straddle"] = _straddle(mesh, device, x, shard)
        if rank == 0:
            devices = ([torch.device("cuda", i) for i in range(world)] if cuda
                       else [device, device])
            res["serving"] = _serving(state.model, device, devices)
        distributed.host_barrier("tpuseg_torch:dryrun-exit")
        distributed.shutdown_distributed()
        results.put((rank, res, None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def dryrun_multigpu(n: int = 2, timeout_s: float = 300.0) -> dict:
    """Run the dry run on ``n`` ranks (module docstring) and return rank 0's
    results plus every rank's losses; raises if a rank fails, disagrees or
    does not finish within ``timeout_s``."""
    import torch.multiprocessing as mp

    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= n
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # a file rendezvous: a port found free could be bound by another
    # process before rank 0 binds it
    work = tempfile.TemporaryDirectory(prefix="tpuseg-dryrun-")
    rdzv = f"file://{work.name}/rdzv"
    procs = [ctx.Process(target=_rank_main, args=(r, n, rdzv, cuda, results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        got = {}
        for _ in procs:
            try:
                rank, res, err = results.get(timeout=timeout_s)
            except queue.Empty:
                raise TimeoutError(f"dryrun_multigpu({n}): a rank did not finish in "
                                   f"{timeout_s} s") from None
            if err is not None:
                raise RuntimeError(f"dryrun_multigpu({n}): rank {rank} failed:\n{err}")
            got[rank] = res
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        work.cleanup()
    keys = ("data_parallel", "zero1", "raw_zero1")
    for rank in range(1, n):
        if any(got[rank].get(k) != got[0].get(k) for k in keys + ("straddle",)):
            raise AssertionError(f"ranks disagree on the global losses: {got}")
    out = dict(got[0])
    out["ranks"] = n
    return out
