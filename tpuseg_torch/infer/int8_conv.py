"""K3: SAME int8 conv with int32 accumulation and the quantized block's
epilogue fused.

In the JAX package each quantized block is XLA's ``conv_general_dilated``
on int8 codes with int32 accumulation (``tpuseg/infer/quant.py:173``
``_conv_s8``), followed by an epilogue that XLA fuses into the same pass
inside ``_quantized_raw_fn``. The port has no such compiler, so this module
holds that work as one function, :func:`int8_conv`, whose epilogue is data
(:class:`Epilogue`), one of three modes:

- ``"relu_requant"`` (a conv block): ``q = clamp(rint((max(f(acc) * ws + b,
  0) * s + t) / so), -127, 127)`` as int8;
- ``"relu_f32"`` (the last block, an int8 head): the same without the
  requantize, as f32;
- ``"affine_requant"`` (a deconv as a 1x1 conv to phase-major ``4*cout``):
  ``q = clamp(rint(((f(acc) * ws) * s + t) / so), -127, 127)`` as int8.

On a CUDA tensor it launches the hand-written implicit-GEMM kernel in
``tpuseg_torch/csrc/int8_conv.cu`` (built at first use by
:mod:`tpuseg_torch.kernels.build`) or raises; on a CPU tensor it runs
:func:`_int8_conv_plain`, the same function in plain PyTorch: an im2col
built from shifted slices (int8 ``F.unfold`` has no CUDA kernel) fed to
``torch._int_mm``, chunked over output rows so the im2col stays under
``_IM2COL_BYTES``, with the epilogue applied per chunk. Nothing falls back
from one to the other. ``LAUNCHES`` counts kernel launches,
``ROUTE_LAUNCHES`` counts them by route, and ``LAST_ROUTE`` names the
route of the last one.

The kernel has two routes, chosen by :func:`kernel_route` from ``Cin``:
``"wgmma"`` for ``Cin % 16 == 0`` (every block of the served walk): a
producer warp keeps a ring of shared-memory stages full with TMA, the
input tile as a ``bh x bw`` patch of one image (SAME padding and the Cin
tail come from TMA's zero fill), and two consumer warpgroups multiply with
``wgmma``; ``"mma"`` for any ``Cin`` (the packed-tap layout of a quantized
input layer, and a yardstick): ``cp.async`` and ``mma.sync``. Both run
only the 64-byte K-steps whose weight codes are not all zero within their
N tile (:func:`_skip_lists`): the blocked edge convs' structural zeros,
3/4 of their K-steps, are never loaded or multiplied. The N-tile width
(:func:`n_tile_width`) and the patch width (:func:`patch_width`) are plain
functions of shapes and skip counts.

Both compute the same IEEE float operations in the same order, and the
int32 sums are exact, so the kernel is bit-equal to the plain version.
The weights are laid out once per device (:class:`Int8ConvWeights`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# Kernel launches since the counter was last reset (CPU calls don't count),
# in all and by route; the route of the last launch.
LAUNCHES = 0
ROUTES = ("wgmma", "mma")
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
LAST_ROUTE = None

# im2col bytes per chunk of the plain version
_IM2COL_BYTES = 1 << 30

# The kernel's K-step in bytes (csrc/int8_conv.cu kBK): each tap's Cin is
# padded to it in the kernel's weight layout.
_KSTEP = 64

# Output pixels per tile of either route (a bh x bw patch on "wgmma").
_TILE_M = 128
# N-tile widths of the "wgmma" route; the "mma" route's tile is 128 wide.
N_TILES = (64, 128, 256)
_MMA_BN = 128
# Patch widths of the "wgmma" route (bh = 128 / bw).
PATCH_WIDTHS = (16, 32, 64, 128)
# The "wgmma" route's cost model at each N-tile width, in units of one K-step
# of a 64-wide tile: one K-step of a tile, and the fixed cost of a tile (its
# start, pipeline fill and epilogue). Fitted (least squares, relative error)
# to the route's times at each width at the 21 block shapes of a predict call
# (chip_smoke.py phase 2, `wgmma_ms_by_bn`; NVIDIA H100 80GB HBM3 at 700 W):
# within 6% at widths 64 and 128, 25% at 256.
_STEP_COST = {64: 1.0, 128: 1.41, 256: 2.61}
_TILE_COST = {64: 10.3, 128: 23.7, 256: 65.7}

MODES = {"relu_requant": 0, "relu_f32": 1, "affine_requant": 2}
_ROUTE_CODES = {"mma": 0, "wgmma": 1}


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


@dataclass(frozen=True)
class Epilogue:
    """One of :data:`MODES` and its per-output-channel f32 vectors ``ws``,
    ``b`` (not in ``"affine_requant"``), ``s``, ``t``, and the 0-dim f32
    output scale ``so`` (not in ``"relu_f32"``), as tensors on the conv's
    device. ``so`` divides as a device tensor: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, which rounds differently
    from the true division the JAX package does."""

    mode: str
    ws: torch.Tensor
    b: Optional[torch.Tensor]
    s: torch.Tensor
    t: torch.Tensor
    so: Optional[torch.Tensor]

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"epilogue mode {self.mode!r} not in {sorted(MODES)}")
        if (self.b is None) != (self.mode == "affine_requant"):
            raise ValueError(f"mode {self.mode!r}: b must be "
                             f"{'None' if self.mode == 'affine_requant' else 'given'}")
        if (self.so is None) != (self.mode == "relu_f32"):
            raise ValueError(f"mode {self.mode!r}: so must be "
                             f"{'None' if self.mode == 'relu_f32' else 'given'}")

    def __call__(self, y32: torch.Tensor) -> torch.Tensor:
        """The epilogue in plain PyTorch on int32 sums ``(..., cout)``."""
        if self.mode == "affine_requant":
            y = y32.float() * self.ws * self.s + self.t
        else:
            y = torch.clamp_min(y32.float() * self.ws + self.b, 0.0) * self.s + self.t
            if self.mode == "relu_f32":
                return y
        return torch.clamp(torch.round(y / self.so), -127, 127).to(torch.int8)


def _kernel_layout(wq: np.ndarray) -> np.ndarray:
    """HWIO int8 codes -> the kernel's ``(cout, kp)`` K-major matrix: for
    ``cin % 16 == 0`` each tap's ``cin`` padded with zeros to the K-step,
    else all taps packed and ``kh*kw*cin`` padded once."""
    kh, kw, cin, cout = wq.shape
    taps = kh * kw
    w = np.ascontiguousarray(wq.reshape(taps, cin, cout).transpose(2, 0, 1))
    if cin % 16 == 0:
        wm = np.zeros((cout, taps, _round_up(cin, _KSTEP)), np.int8)
        wm[:, :, :cin] = w
        return wm.reshape(cout, -1)
    wm = np.zeros((cout, _round_up(taps * cin, _KSTEP)), np.int8)
    wm[:, :taps * cin] = w.reshape(cout, -1)
    return wm


def _skip_lists(wm: np.ndarray, bn: int):
    """For N tiles ``bn`` columns wide: ``(steps, counts)``, int32 arrays
    ``(n_tiles, ksteps)`` and ``(n_tiles,)``. Row ``t`` of ``steps`` starts
    with the ``counts[t]`` K-steps (64-byte slices of ``wm``'s K) whose codes
    are not all zero in rows ``t*bn .. t*bn+bn-1``, in increasing order;
    the rest of the row is -1. Found from the codes alone."""
    cout, kp = wm.shape
    ksteps = kp // _KSTEP
    n_tiles = -(-cout // bn)
    nz = np.zeros((n_tiles * bn, ksteps), bool)
    nz[:cout] = (wm.reshape(cout, ksteps, _KSTEP) != 0).any(axis=2)
    nz = nz.reshape(n_tiles, bn, ksteps).any(axis=1)
    counts = nz.sum(axis=1).astype(np.int32)
    steps = np.full((n_tiles, ksteps), -1, np.int32)
    for t in range(n_tiles):
        idx = np.flatnonzero(nz[t])
        steps[t, :len(idx)] = idx
    return steps, counts


def needed_macs(wq: np.ndarray) -> int:
    """Multiply-adds per output pixel that the weights need: for each
    output channel, the input channels of each 64-byte K-step of its laid-out
    row whose codes are not all zero (the zero padding of the layout not
    counted). Dense random codes need ``kh*kw*cin*cout``; the blocked edge
    convs' structural zeros drop out (a quarter of that for their 3x3s)."""
    kh, kw, cin, _ = wq.shape
    wm = _kernel_layout(wq)
    cout, kp = wm.shape
    ksteps = kp // _KSTEP
    nz = (wm.reshape(cout, ksteps, _KSTEP) != 0).any(axis=2)
    if cin % 16 == 0:
        per_tap = -(-cin // _KSTEP)
        c0 = (np.arange(ksteps) % per_tap) * _KSTEP
        valid = np.minimum(_KSTEP, cin - c0)
    else:
        valid = np.minimum(_KSTEP, kh * kw * cin - np.arange(ksteps) * _KSTEP)
    return int((nz * valid).sum())


def kernel_route(cin: int) -> str:
    """``"wgmma"`` where TMA can address ``x`` (its pixel stride, ``Cin``
    bytes, a multiple of 16), else ``"mma"``."""
    return "wgmma" if cin % 16 == 0 else "mma"


def n_tile_width(route: str, cout: int, counts: Dict[int, np.ndarray]) -> int:
    """The N-tile width of a launch: 128 on ``"mma"``; on ``"wgmma"`` the
    width in :data:`N_TILES` whose tiles cost least, the K-steps they run
    (``counts[bn]`` from :func:`_skip_lists`) at ``_STEP_COST`` plus each
    tile at ``_TILE_COST``, the wider on a tie. A dense Cout = 64 conv
    takes 64; so do the blocked convs, whose 64-wide tiles each skip 3/4
    of their K-steps."""
    if route == "mma":
        return _MMA_BN
    if route != "wgmma":
        raise ValueError(f"route {route!r} not in {ROUTES}")
    cost = {bn: int(np.asarray(counts[bn]).sum()) * _STEP_COST[bn]
            + len(counts[bn]) * _TILE_COST[bn] for bn in N_TILES}
    return min(N_TILES, key=lambda bn: (cost[bn], -bn))


def patch_width(h: int, w: int) -> int:
    """The ``"wgmma"`` route's patch width ``bw`` (``bh = 128 / bw``): the
    one in :data:`PATCH_WIDTHS` whose patches cover ``h x w`` with the
    fewest pixels, the wider on a tie."""
    def area(bw):
        bh = _TILE_M // bw
        return -(-w // bw) * bw * (-(-h // bh) * bh)

    return min(PATCH_WIDTHS, key=lambda bw: (area(bw), -bw))


@dataclass(frozen=True)
class KernelWeights:
    """The kernel's operands of one conv on one device: the laid-out codes
    ``wm`` ``(cout, kp)`` int8, and for each N-tile width the skip lists
    (``steps``, ``counts``: int32 on the device) with the counts also on
    the host (``host_counts``), for :func:`n_tile_width`."""

    wm: torch.Tensor
    steps: Dict[int, torch.Tensor]
    counts: Dict[int, torch.Tensor]
    host_counts: Dict[int, np.ndarray]


class Int8ConvWeights:
    """The HWIO int8 codes ``wq`` of one conv, laid out once on each device
    that asks: ``(cout, kh*kw*cin)`` zero-padded to multiples of 8 for the
    plain version (``torch._int_mm`` wants K and N so), the kernel's
    :func:`_kernel_layout` and skip lists for CUDA launches."""

    def __init__(self, wq: np.ndarray):
        if wq.dtype != np.int8 or wq.ndim != 4:
            raise TypeError(f"wq must be int8 HWIO, got {wq.dtype} {wq.shape}")
        self.kh, self.kw, self.cin, self.cout = wq.shape
        self.k = self.kh * self.kw * self.cin
        self._wq = wq
        self._plain: Dict[torch.device, torch.Tensor] = {}
        self._kernel: Dict[torch.device, KernelWeights] = {}

    def plain(self, device: torch.device) -> torch.Tensor:
        wm = self._plain.get(device)
        if wm is None:
            a = np.zeros((_round_up(self.cout, 8), _round_up(self.k, 8)), np.int8)
            a[:self.cout, :self.k] = self._wq.reshape(self.k, self.cout).T
            wm = self._plain[device] = torch.from_numpy(a).to(device)
        return wm

    def kernel(self, device: torch.device) -> KernelWeights:
        kw = self._kernel.get(device)
        if kw is None:
            wm = _kernel_layout(self._wq)
            lists = {bn: _skip_lists(wm, bn) for bn in sorted(set(N_TILES) | {_MMA_BN})}
            kw = self._kernel[device] = KernelWeights(
                torch.from_numpy(wm).to(device),
                {bn: torch.from_numpy(st).to(device) for bn, (st, _) in lists.items()},
                {bn: torch.from_numpy(c).to(device) for bn, (_, c) in lists.items()},
                {bn: c for bn, (_, c) in lists.items()})
        return kw


def _im2col(xp: torch.Tensor, x: torch.Tensor, weights: Int8ConvWeights, kp: int,
            r0: int, r1: int) -> torch.Tensor:
    """Rows ``r0:r1`` of the im2col matrix ``(B*(r1-r0)*W, kp)`` from the
    SAME-padded input ``xp``, zero columns past K."""
    b, _, w, _ = x.shape
    cols = [xp[:, r0 + ky:r1 + ky, kx:kx + w]
            for ky in range(weights.kh) for kx in range(weights.kw)]
    if kp > weights.k:
        cols.append(x.new_zeros((b, r1 - r0, w, kp - weights.k)))
    return torch.cat(cols, dim=-1).reshape(-1, kp) if len(cols) > 1 \
        else cols[0].reshape(-1, kp)


def _pad_same(x: torch.Tensor, weights: Int8ConvWeights) -> torch.Tensor:
    ph, pw = weights.kh // 2, weights.kw // 2
    return F.pad(x, (0, 0, pw, pw, ph, ph)) if ph or pw else x


def _int8_conv_plain(x: torch.Tensor, weights: Int8ConvWeights,
                     epilogue: Optional[Epilogue]) -> torch.Tensor:
    """The kernel's function in plain PyTorch (any device): im2col +
    ``torch._int_mm`` per chunk of output rows, ``epilogue`` applied per
    chunk and the chunks stitched into ``(B, H, W, cout)``. With ``epilogue``
    None it returns the int32 sums."""
    wm = weights.plain(x.device)
    b, h, w, _ = x.shape
    xp = _pad_same(x, weights)
    kp = wm.shape[1]
    rows = max(1, min(h, _IM2COL_BYTES // max(1, b * w * kp)))
    out = None
    for r0 in range(0, h, rows):
        r1 = min(h, r0 + rows)
        a = _im2col(xp, x, weights, kp, r0, r1)
        m = a.shape[0]
        if m <= 16:  # cuBLASLt's int8 GEMM wants M > 16
            a = torch.cat([a, a.new_zeros((17 - m, kp))])
        y = torch._int_mm(a, wm.t())[:m, :weights.cout].reshape(b, r1 - r0, w, weights.cout)
        if epilogue is not None:
            y = epilogue(y)
        if out is None:
            out = y.new_empty((b, h, w, weights.cout))
        out[:, r0:r1] = y
    return out


def _check(x: torch.Tensor, weights: Int8ConvWeights, epilogue: Epilogue, route: str,
           bn: int, bw: int) -> None:
    if x.dtype != torch.int8 or x.dim() != 4:
        raise TypeError(f"x must be 4-D int8 NHWC, got {x.dtype} {tuple(x.shape)}")
    b, h, w, cin = x.shape
    if cin != weights.cin:
        raise ValueError(f"x has {cin} channels, the weights take {weights.cin}")
    if (weights.kh, weights.kw) not in ((1, 1), (3, 3)):
        raise ValueError(f"the kernel takes 1x1 and 3x3 convs, not {weights.kh}x{weights.kw}")
    if min(b, h, w) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for 16-byte copies")
    if route == "wgmma" and cin % 16:
        raise ValueError(f"the wgmma route needs Cin % 16 == 0 (TMA strides), got Cin {cin}")
    vecs = [("ws", epilogue.ws), ("s", epilogue.s), ("t", epilogue.t)]
    if epilogue.b is not None:
        vecs.append(("b", epilogue.b))
    for name, v in vecs + ([("so", epilogue.so)] if epilogue.so is not None else []):
        if v.dtype != torch.float32 or v.device != x.device or not v.is_contiguous():
            raise ValueError(f"epilogue {name} must be contiguous float32 on {x.device}, "
                             f"got {v.dtype} on {v.device}")
    for name, v in vecs:
        if tuple(v.shape) != (weights.cout,):
            raise ValueError(f"epilogue {name} has shape {tuple(v.shape)}, "
                             f"want ({weights.cout},)")
    if epilogue.so is not None and epilogue.so.numel() != 1:
        raise ValueError(f"epilogue so must be a scalar, got {tuple(epilogue.so.shape)}")
    m = b * h * w
    if route == "wgmma":
        bh = _TILE_M // bw
        m_tiles = b * -(-h // bh) * -(-w // bw)
    else:
        m_tiles = -(-m // _TILE_M)
    tiles = m_tiles * -(-weights.cout // bn)
    if m >= 2 ** 31 or tiles >= 2 ** 31:
        raise ValueError(f"{m} output pixels ({tiles} tiles) exceed the kernel's "
                         "32-bit index range")


def _launch(x: torch.Tensor, weights: Int8ConvWeights, epilogue: Epilogue,
            route: Optional[str] = None, bn: Optional[int] = None) -> torch.Tensor:
    """One kernel launch on ``route`` (default :func:`kernel_route`) with
    N tiles ``bn`` wide (default :func:`n_tile_width`); ``chip_smoke.py``
    passes both to time the routes and widths side by side."""
    global LAUNCHES, LAST_ROUTE
    from tpuseg_torch.kernels.build import load

    b, h, w, cin = x.shape
    route = kernel_route(cin) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    op = weights.kernel(x.device)
    bn = n_tile_width(route, weights.cout, op.host_counts) if bn is None else bn
    if bn not in (N_TILES if route == "wgmma" else (_MMA_BN,)):
        raise ValueError(f"N tile {bn} not taken by the {route} route")
    bw = patch_width(h, w)
    _check(x, weights, epilogue, route, bn, bw)
    lib = load("int8_conv")
    dtype = torch.float32 if epilogue.mode == "relu_f32" else torch.int8
    out = torch.empty((b, h, w, weights.cout), dtype=dtype, device=x.device)
    e = epilogue

    def ptr(t):
        return None if t is None else t.data_ptr()

    steps = op.steps[bn]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.tpuseg_int8_conv(
            x.data_ptr(), op.wm.data_ptr(), e.ws.data_ptr(), ptr(e.b), e.s.data_ptr(),
            e.t.data_ptr(), ptr(e.so), out.data_ptr(), steps.data_ptr(),
            op.counts[bn].data_ptr(), steps.shape[1], b, h, w, cin, weights.cout,
            weights.kh, weights.kw, op.wm.shape[1], MODES[e.mode], _ROUTE_CODES[route], bn,
            bw, stream)
    if err:
        msg = lib.tpuseg_cuda_error_string(err).decode()
        raise RuntimeError(f"int8_conv kernel launch failed ({route} route): {msg} ({err})")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    LAST_ROUTE = route
    return out


def int8_conv(x: torch.Tensor, weights: Int8ConvWeights, epilogue: Epilogue) -> torch.Tensor:
    """SAME stride-1 conv of NHWC int8 ``x`` with ``weights``, int32 sums,
    then ``epilogue``: ``(B, H, W, cout)`` int8, or f32 in ``"relu_f32"``."""
    dev = x.device
    if dev.type == "cpu":
        return _int8_conv_plain(x, weights, epilogue)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu tensors, not {dev}")
    return _launch(x, weights, epilogue)
