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

**Heights.** The port takes the heights the JAX package takes under
``spatial`` N: ``H % 16 == 0`` and ``H % N == 0`` (:func:`check_height`).
Each rank holds ``h_l = H / (N 2^l)`` rows at level ``l`` of the U-Net
(level 0 is enc1/dec1, level 4 the bottleneck), and a 2x2 pool stays on
one rank while ``h_l`` is even. Where a pool window would straddle two
ranks, at the first level ``L`` whose ``h_L`` is odd (:func:`split_level`),
the model gathers that level's rows over the group before the pool
(:meth:`Halo.gather`), computes every deeper level and the deconv back to
level ``L`` on the full rows, the same on every rank of the group, and
keeps this rank's rows of that deconv's output. The gather's backward
all-reduces the full-height gradient over the group and keeps this rank's
rows (a reduce-scatter; gloo has none). It takes the route of the halo
rows: ``nccl`` card to card, ``gloo`` for CPU tensors, and host-staged
over gloo for CUDA tensors.

The exchange, the gather and the gather's backward are profiler spans
(``utils/profiling.span``), ``halo_exchange:<route>``, ``row_gather:<route>``
and ``row_gather_backward:<route>``, inside ``profiling.spans()``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from tpuseg_torch import SIZE_FACTOR
from tpuseg_torch.utils.profiling import span


def check_height(height: int, spatial: int) -> None:
    """Raise unless ``height`` rows shard over ``spatial`` ranks under the
    JAX package's rules: the height a multiple of ``SIZE_FACTOR`` (16) and
    divisible by ``spatial``."""
    if spatial > 1 and (height % SIZE_FACTOR or height % spatial):
        raise ValueError(
            f"image height {height} cannot be partitioned over spatial={spatial}: the "
            f"height must be a multiple of {SIZE_FACTOR} and divide by spatial={spatial}")


def split_level(height: int, spatial: int) -> Optional[int]:
    """The level (0-3) whose rows a spatial group of ``spatial`` ranks
    gathers before its 2x2 pool, because each rank holds an odd number of
    rows there (module docstring); None when every pool stays on one rank
    (``height / spatial`` a multiple of 16). Raises as :func:`check_height`."""
    check_height(height, spatial)
    if spatial == 1:
        return None
    rows = height // spatial
    for level in range(4):
        if rows % 2:
            return level
        rows //= 2
    return None


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
    ``halo(x)`` pads NCHW ``x`` with its neighbours' rows, differentiably;
    ``halo.gather(x)`` joins the group's rows into the full height.
    ``exchanges`` and ``bytes_sent`` count what the exchange has sent,
    ``gathers`` and ``gather_bytes`` the gather's collectives and their
    bytes (this rank's rows forward, the full height backward), forward and
    backward."""

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
        self.gathers = 0
        self.gather_bytes = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _HaloPad.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The group's NCHW row blocks, this rank's ``x`` among them, joined
        in rank order into the full height, channels-last. Backward: the
        full-height gradient summed over the group, this rank's rows."""
        return _GatherRows.apply(x, self)

    def _staged(self) -> bool:
        """Whether the tensors go through host buffers (``gloo-host-staged``);
        if so, first wait for the card's queued work, which the copies to
        the host would wait for, so the profiled range holds the exchange or
        the gather alone."""
        staged = self.route == "gloo-host-staged"
        if staged:
            torch.cuda.current_stream(self.device).synchronize()
        return staged

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of ``t``."""
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        staged = self._staged()
        with span(f"row_gather:{self.route}"):
            block = x.permute(0, 2, 3, 1).contiguous()  # NHWC
            if staged:
                block = self._host(block)
            parts = [torch.empty_like(block) for _ in range(self.size)]
            dist.all_gather(parts, block, group=self.group)
            self.gathers += 1
            self.gather_bytes += block.numel() * block.element_size()
            full = torch.cat(parts, dim=1)
            if staged:
                full = full.to(self.device)
        return full.permute(0, 3, 1, 2)

    def reduce_rows(self, g: torch.Tensor) -> torch.Tensor:
        """Full-height NCHW ``g`` summed over the group; this rank's rows."""
        staged = self._staged()
        with span(f"row_gather_backward:{self.route}"):
            t = g.permute(0, 2, 3, 1)  # NHWC
            # a copy: the all-reduce works in place
            t = self._host(t) if staged else t.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(t, group=self.group)
            self.gathers += 1
            self.gather_bytes += t.numel() * t.element_size()
            h = t.shape[1] // self.size
            mine = t[:, self.rank * h:(self.rank + 1) * h]
            mine = mine.to(self.device) if staged else mine.contiguous()
        return mine.permute(0, 3, 1, 2)

    def exchange(self, t: torch.Tensor):
        """Send NCHW ``t``'s first row to the rank above and its last row to
        the rank below; return (the row from above, the row from below) as
        NHWC rows, None at the group's edges."""
        staged = self._staged()
        with span(f"halo_exchange:{self.route}"):
            ops, recv = [], []
            for peer, i in ((self.up, 0), (self.down, t.shape[2] - 1)):
                if peer is None:
                    recv.append(None)
                    continue
                row = _row(t, i)
                if staged:
                    row = self._host(row)
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


class _GatherRows(torch.autograd.Function):
    """Forward: the group's row blocks joined into the full height.
    Backward: every rank's full-height gradient summed, this rank's rows
    kept."""

    @staticmethod
    def forward(ctx, x, halo: Halo):
        ctx.halo = halo
        return halo.all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.halo.reduce_rows(g), None


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


def gather_rows_reference(shards: List[torch.Tensor]) -> List[torch.Tensor]:
    """The whole gather in one process: what each rank of a spatial group
    holds after :meth:`Halo.gather` of its NCHW row shard (in rank order),
    the shards joined along the rows. Differentiable through ``torch.cat``:
    a shard's gradient sums every rank's gradient at its rows."""
    return [torch.cat(shards, dim=2) for _ in shards]
