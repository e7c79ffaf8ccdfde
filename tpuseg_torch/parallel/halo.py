"""The halo exchange of spatial partitioning: image rows sharded over a
group of ranks, one halo row on each side of every 3x3 conv.

The JAX package has no module for this: GSPMD partitions the convolutions
of a ``(data, spatial)`` mesh and inserts the halo exchanges as
collective-permutes (``tpuseg/parallel/mesh.py:9-12``). The port inserts
them itself. Each rank of a spatial group holds ``h`` consecutive rows of
every image; before a 3x3 conv it takes the last row of the rank above and
the first row of the rank below, so that the conv with ``padding=(0, 1)``
computes exactly its rows of the unsharded conv with ``padding=1``. At the
image's global top and bottom the halo row is zeros, the conv's own
padding. The backward sends each halo row's gradient back to the rank that
owns the row, which adds it to its boundary row.

The two rows travel as point-to-point sends and receives
(``dist.batch_isend_irecv``). The route is chosen from the group's backend
and the tensor's device, never because another route failed:

- ``nccl``: the rows go card to card (NCCL takes CUDA tensors);
- ``gloo``: CPU tensors, sent as they are;
- ``gloo-host-staged``: gloo has no send or receive of CUDA tensors, so the
  rows are copied to pinned host buffers, sent, and copied back. This is
  the route of two ranks on one card, which NCCL refuses.

Activations are NCHW views with channels-last strides
(``models/unet.py``); the padded tensor keeps that layout, and a row is
sent as a packed ``[N, 1, W, C]`` block.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from tpuseg_torch import SIZE_FACTOR


def check_height(height: int, spatial: int) -> None:
    """Raise unless ``height`` rows shard over ``spatial`` ranks with every
    rank's rows a multiple of ``SIZE_FACTOR`` (16), so that each of the
    four 2x2 pools stays on one rank. The JAX package asks less: ``H %
    16 == 0`` and ``H % spatial == 0`` (GSPMD handles a pool window split
    between two ranks); the port refuses the heights between the two."""
    if spatial > 1 and height % (SIZE_FACTOR * spatial):
        raise ValueError(
            f"image height {height} cannot be partitioned over spatial={spatial}: the "
            f"height must be a multiple of {SIZE_FACTOR} and divide by spatial={spatial} "
            f"(the JAX package's rules), and each rank's {height}/{spatial} rows must be a "
            f"multiple of {SIZE_FACTOR} so that the four 2x2 pools stay on one rank: "
            f"H must be a multiple of {SIZE_FACTOR}*{spatial} = {SIZE_FACTOR * spatial}")


def local_rows(t: torch.Tensor, rows: Tuple[int, int]) -> torch.Tensor:
    """Rank ``rows[0]``'s share of an NHWC (or NHW) batch whose rows shard
    over ``rows[1]`` ranks: ``t[:, r*h:(r+1)*h]`` with ``h = H / rows[1]``."""
    rank, size = rows
    if size == 1:
        return t
    check_height(t.shape[1], size)
    h = t.shape[1] // size
    return t[:, rank * h:(rank + 1) * h]


def halo_route(group, device: torch.device) -> str:
    """The route the rows of ``device`` tensors take over ``group``
    (module docstring)."""
    backend = dist.get_backend(group)
    if backend == "nccl" and device.type == "cuda":
        return "nccl"
    if backend == "gloo":
        return "gloo-host-staged" if device.type == "cuda" else "gloo"
    raise ValueError(f"no halo route for backend {backend!r} with {device.type} tensors")


def _row(t: torch.Tensor, i: int) -> torch.Tensor:
    """Row ``i`` of NCHW ``t`` as a packed NHWC ``[N, 1, W, C]`` tensor."""
    return t[:, :, i:i + 1].permute(0, 2, 3, 1).contiguous()


def _nchw(row: torch.Tensor) -> torch.Tensor:
    return row.permute(0, 3, 1, 2)


def pad_rows(x: torch.Tensor, above: Optional[torch.Tensor],
             below: Optional[torch.Tensor]) -> torch.Tensor:
    """NCHW ``x`` with the NHWC row ``above`` (zeros if None) on top and
    ``below`` (zeros if None) under it, channels-last."""
    n, c, h, w = x.shape
    out = torch.empty((n, c, h + 2, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    out[:, :, 1:h + 1] = x
    for i, row in ((0, above), (h + 1, below)):
        if row is None:
            out[:, :, i:i + 1].zero_()
        else:
            out[:, :, i:i + 1] = _nchw(row)
    return out


class Halo:
    """This rank's place in its spatial group and the exchange over it.
    ``halo(x)`` pads NCHW ``x`` with its neighbours' rows, differentiably.
    ``exchanges`` and ``bytes_sent`` count what it has sent (forward and
    backward)."""

    def __init__(self, group, device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device)
        self.route = halo_route(group, self.device)
        self.up = dist.get_global_rank(group, self.rank - 1) if self.rank > 0 else None
        self.down = (dist.get_global_rank(group, self.rank + 1)
                     if self.rank < self.size - 1 else None)
        self.exchanges = 0
        self.bytes_sent = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _HaloPad.apply(x, self)

    def exchange(self, t: torch.Tensor):
        """Send NCHW ``t``'s first row to the rank above and its last row to
        the rank below; return (the row from above, the row from below) as
        NHWC rows, None at the group's edges."""
        staged = self.route == "gloo-host-staged"
        if staged:
            # the copies below would wait for the card's queued work; wait
            # here, so the profiled range holds the exchange alone
            torch.cuda.current_stream(self.device).synchronize()
        with torch.profiler.record_function(f"halo_exchange:{self.route}"):
            ops, recv = [], []
            for peer, i in ((self.up, 0), (self.down, t.shape[2] - 1)):
                if peer is None:
                    recv.append(None)
                    continue
                row = _row(t, i)
                if staged:
                    row = torch.empty(row.shape, dtype=row.dtype,
                                      pin_memory=True).copy_(row)
                buf = torch.empty_like(row)
                ops += [dist.P2POp(dist.isend, row, peer, self.group),
                        dist.P2POp(dist.irecv, buf, peer, self.group)]
                recv.append(buf)
                self.bytes_sent += row.numel() * row.element_size()
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            self.exchanges += 1
            if staged:
                recv = [None if r is None else r.to(self.device, non_blocking=True)
                        for r in recv]
        return recv[0], recv[1]


class _HaloPad(torch.autograd.Function):
    """Forward: pad with the neighbours' boundary rows. Backward: the halo
    rows' gradients go back to their owners and are added to their
    boundary rows."""

    @staticmethod
    def forward(ctx, x, halo: Halo):
        ctx.halo = halo
        above, below = halo.exchange(x)
        return pad_rows(x, above, below)

    @staticmethod
    def backward(ctx, g):
        h = g.shape[2] - 2
        # the top halo row's gradient goes up, the bottom one's down; back
        # come the gradients of this rank's first and last rows
        from_above, from_below = ctx.halo.exchange(g)
        gx = g[:, :, 1:h + 1].clone(memory_format=torch.channels_last)
        if from_above is not None:
            gx[:, :, :1] += _nchw(from_above)
        if from_below is not None:
            gx[:, :, h - 1:] += _nchw(from_below)
        return gx, None


def pad_rows_reference(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """The whole exchange in one process: each of a spatial group's NCHW
    row shards (in rank order) padded with its neighbours' boundary rows,
    zeros at the image's edges. Differentiable through ``torch.cat``."""
    out = []
    for r, x in enumerate(shards):
        zero = torch.zeros_like(x[:, :, :1])
        above = shards[r - 1][:, :, -1:] if r > 0 else zero
        below = shards[r + 1][:, :, :1] if r < len(shards) - 1 else zero
        out.append(torch.cat([above, x, below], dim=2))
    return out
