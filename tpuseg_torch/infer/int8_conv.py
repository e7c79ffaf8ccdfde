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

The int8 walk's edge ops, which XLA fused into the jitted predict on the
TPU (``tpuseg/infer/quant.py``: ``_maxpool`` :157, ``phase_max`` :651, the
skip concats :590-594 and :688, ``_d2s`` :212), are store forms of the
same call, on the ``"wgmma"`` route: ``out=`` (a channel slice of a wider
NHWC buffer: the concat), ``d2s=True`` (the deconv's depth-to-space) and
``pool="spatial"`` or ``"phase"`` (a second, pooled output: the 2x2 max, or
the max over a blocked pixel's four phase groups). :func:`form_problem`
says which calls the kernel takes; the plain version composes the eager
ops for the same contract.
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
# The pooled output of a store: the 2x2/2 max of each window, or the max
# over the four phase groups (channel n = phase * F + c) of each pixel.
POOLS = {None: 0, "spatial": 1, "phase": 2}
# Patch widths whose patches have an even row count (bh = 128 / bw >= 2):
# a spatial pool's windows then lie inside one patch.
_POOL_PATCH_WIDTHS = tuple(bw for bw in PATCH_WIDTHS if _TILE_M // bw >= 2)


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


def n_tile_width(route: str, cout: int, counts: Dict[int, np.ndarray],
                 pool: Optional[str] = None) -> int:
    """The N-tile width of a launch: 128 on ``"mma"``; on ``"wgmma"`` the
    width in :data:`N_TILES` whose tiles cost least, the K-steps they run
    (``counts[bn]`` from :func:`_skip_lists`) at ``_STEP_COST`` plus each
    tile at ``_TILE_COST``, the wider on a tie. A dense Cout = 64 conv
    takes 64; so do the blocked convs, whose 64-wide tiles each skip 3/4
    of their K-steps. A phase max takes the widths that hold a pixel's
    four phase groups in one tile or one group a tile
    (:func:`_phase_width`): the blocked enc1b at base 64 takes 64."""
    if route == "mma":
        return _MMA_BN
    if route != "wgmma":
        raise ValueError(f"route {route!r} not in {ROUTES}")
    widths = [bn for bn in N_TILES if pool != "phase" or _phase_width(bn, cout)]
    if not widths:
        return max(N_TILES)
    cost = {bn: int(np.asarray(counts[bn]).sum()) * _STEP_COST[bn]
            + len(counts[bn]) * _TILE_COST[bn] for bn in widths}
    return min(widths, key=lambda bn: (cost[bn], -bn))


def _phase_width(bn: int, cout: int) -> bool:
    """Whether N tiles ``bn`` wide take a phase max over ``cout = 4F``
    channels: one tile holds all four phase groups, or each of the four
    tiles is one group (F = bn = 64; one block computes them in turn and
    keeps the running max in registers)."""
    return bn >= cout or (4 * bn == cout and bn == 64)


def patch_width(h: int, w: int, pool: Optional[str] = None) -> int:
    """The ``"wgmma"`` route's patch width ``bw`` (``bh = 128 / bw``): the
    one in :data:`PATCH_WIDTHS` whose patches cover ``h x w`` with the
    fewest pixels, the wider on a tie; for a spatial pool only those of an
    even row count (``bw <= 64``)."""
    def area(bw):
        bh = _TILE_M // bw
        return -(-w // bw) * bw * (-(-h // bh) * bh)

    widths = _POOL_PATCH_WIDTHS if pool == "spatial" else PATCH_WIDTHS
    return min(widths, key=lambda bw: (area(bw), -bw))


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


def _d2s(x: torch.Tensor) -> torch.Tensor:
    """Depth-to-space: (B, h, w, 4C) -> (B, 2h, 2w, C), phase-major."""
    b, h, w, c4 = x.shape
    x = x.reshape(b, h, w, 2, 2, c4 // 4)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c4 // 4)


def _pooled(y: torch.Tensor, pool: str) -> torch.Tensor:
    """The 2x2/2 max of NHWC ``y`` (``"spatial"``), or the max over the four
    phase groups of its channels (``"phase"``)."""
    b, h, w, c = y.shape
    if pool == "spatial":
        return y.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return y.reshape(b, h, w, 4, c // 4).amax(dim=3)


def _int8_conv_plain(x: torch.Tensor, weights: Int8ConvWeights,
                     epilogue: Optional[Epilogue], out: Optional[torch.Tensor] = None,
                     d2s: bool = False, pool: Optional[str] = None):
    """The kernel's function in plain PyTorch (any device): im2col +
    ``torch._int_mm`` per chunk of output rows, ``epilogue`` applied per
    chunk and the chunks stitched into ``(B, H, W, cout)``. With ``epilogue``
    None it returns the int32 sums. The store forms compose the eager ops:
    ``d2s`` depth-to-spaces the result, ``out`` receives it (a copy into
    the view), and ``pool`` returns ``(y, pooled)``."""
    y = _conv_plain(x, weights, epilogue)
    if d2s:
        y = _d2s(y)
    if out is not None:
        out.copy_(y)
        y = out
    return (y, _pooled(y, pool)) if pool else y


def _conv_plain(x: torch.Tensor, weights: Int8ConvWeights,
                epilogue: Optional[Epilogue]) -> torch.Tensor:
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


def form_problem(x: torch.Tensor, cout: int, mode: str, ctot: Optional[int] = None,
                 d2s: bool = False, pool: Optional[str] = None, *,
                 route: Optional[str] = None, bn: Optional[int] = None,
                 bw: Optional[int] = None) -> Optional[str]:
    """Why :func:`int8_conv` does not take these store forms for ``x``, or
    None, for a conv of ``cout`` output channels in epilogue ``mode``.
    ``ctot`` is the width of the NHWC buffer that ``out`` is a channel
    slice of (None: no ``out``). On any device: an int8 mode; not ``d2s``
    and ``pool`` together; ``cout`` a multiple of 4 for ``d2s`` and a phase
    max; even H and W for a spatial pool; ``ctot >= cout``. On any other
    device (a card; the rules' tests use ``meta`` tensors) the kernel's
    rules as well: the ``"wgmma"`` route (``route``, default
    :func:`kernel_route`); ``cout``, ``ctot`` and a phase's width ``cout /
    4`` multiples of 16, so every 16-byte segment of the store is one run of
    one pixel's channels; an N tile that takes a phase max (``bn``, default
    any, :func:`_phase_width`); a spatial pool's patches of an even row count
    (``bw``, default :func:`patch_width`'s choice)."""
    if ctot is None and not d2s and pool is None:
        return None
    _, h, w, cin = x.shape
    if mode not in ("relu_requant", "affine_requant"):
        return f"the store forms take the int8 modes, not {mode!r}"
    if pool not in POOLS:
        return f"pool {pool!r} not in {sorted(p for p in POOLS if p)}"
    if d2s and pool:
        return "depth-to-space and a pooled output do not combine"
    if (d2s or pool == "phase") and cout % 4:
        return f"depth-to-space and a phase max split Cout into 4 phases, got Cout {cout}"
    if pool == "spatial" and (h % 2 or w % 2):
        return f"a 2x2/2 pool needs an even H and W, got {h} x {w}"
    if ctot is not None and ctot < (cout // 4 if d2s else cout):
        return f"out's buffer has {ctot} channels, fewer than the output's"
    if x.device.type == "cpu":
        return None
    route = kernel_route(cin) if route is None else route
    if route != "wgmma":
        return (f"the store forms run on the wgmma route (Cin % 16 == 0), not the {route} "
                f"route (Cin {cin})")
    phase = cout // 4 if d2s or pool == "phase" else None
    for name, c in (("Cout", cout), ("out's buffer width", ctot), ("a phase's width", phase)):
        if c is not None and c % 16:
            return f"the kernel stores 16-byte segments: {name} {c} is not a multiple of 16"
    if pool == "phase" and not any(_phase_width(w, cout) for w in ([bn] if bn else N_TILES)):
        return (f"a phase max needs Cout {cout} inside one N tile, or one phase an N tile of "
                f"at most 128" + (f", not {bn}" if bn else ""))
    if pool == "spatial" and bw is not None and bw not in _POOL_PATCH_WIDTHS:
        return f"a 2x2 pool needs patches of an even row count (bw <= 64), got bw {bw}"
    return None


def _out_width(out: torch.Tensor, x: torch.Tensor, cout: int, d2s: bool) -> int:
    """The width of the NHWC buffer ``out`` is a channel slice of, after
    checking that it is one, of the output's shape, on ``x``'s device, not
    overlapping ``x`` (and 16-byte aligned on a card)."""
    b, h, w, _ = x.shape
    shape = (b, 2 * h, 2 * w, cout // 4) if d2s else (b, h, w, cout)
    if out.dtype != torch.int8 or out.device != x.device:
        raise ValueError(f"out must be int8 on {x.device}, got {out.dtype} on {out.device}")
    if tuple(out.shape) != shape:
        raise ValueError(f"out has shape {tuple(out.shape)}, want {shape}")
    ctot = out.stride(2)
    if out.stride() != (shape[1] * shape[2] * ctot, shape[2] * ctot, ctot, 1):
        raise ValueError(f"out must be a channel slice of a contiguous NHWC buffer, got strides "
                         f"{out.stride()}")
    lo = out.data_ptr()
    hi = lo + (out.numel() // shape[3] - 1) * ctot + shape[3]
    if lo < x.data_ptr() + x.numel() and x.data_ptr() < hi:
        raise ValueError("out overlaps x")
    if x.device.type == "cuda" and lo % 16:
        raise ValueError("out must be 16-byte aligned for 16-byte stores")
    return ctot


def _check_forms(x, weights, epilogue, out, d2s, pool, **kernel) -> Optional[int]:
    """Raise where :func:`form_problem` finds one; ``out``'s buffer width."""
    ctot = None if out is None else _out_width(out, x, weights.cout, d2s)
    problem = form_problem(x, weights.cout, epilogue.mode, ctot, d2s, pool, **kernel)
    if problem:
        raise ValueError(problem)
    return ctot


def _launch(x: torch.Tensor, weights: Int8ConvWeights, epilogue: Epilogue,
            route: Optional[str] = None, bn: Optional[int] = None,
            out: Optional[torch.Tensor] = None, d2s: bool = False, pool: Optional[str] = None,
            bw: Optional[int] = None):
    """One kernel launch on ``route`` (default :func:`kernel_route`) with
    N tiles ``bn`` wide (default :func:`n_tile_width`) and patches ``bw``
    wide (default :func:`patch_width`); ``chip_smoke.py`` passes them to
    time the routes, widths and patches side by side."""
    global LAUNCHES, LAST_ROUTE
    from tpuseg_torch.kernels.build import current_stream, launch

    b, h, w, cin = x.shape
    route = kernel_route(cin) if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    op = weights.kernel(x.device)
    bn = n_tile_width(route, weights.cout, op.host_counts, pool) if bn is None else bn
    if bn not in (N_TILES if route == "wgmma" else (_MMA_BN,)):
        raise ValueError(f"N tile {bn} not taken by the {route} route")
    bw = patch_width(h, w, pool) if bw is None else bw
    if bw not in PATCH_WIDTHS:
        raise ValueError(f"patch width {bw} not in {PATCH_WIDTHS}")
    _check(x, weights, epilogue, route, bn, bw)
    _check_forms(x, weights, epilogue, out, d2s, pool, route=route, bn=bn, bw=bw)
    cout = weights.cout
    if out is None:
        dtype = torch.float32 if epilogue.mode == "relu_f32" else torch.int8
        shape = (b, 2 * h, 2 * w, cout // 4) if d2s else (b, h, w, cout)
        out = torch.empty(shape, dtype=dtype, device=x.device)
    pooled = None
    if pool == "spatial":
        pooled = torch.empty((b, h // 2, w // 2, cout), dtype=torch.int8, device=x.device)
    elif pool == "phase":
        pooled = torch.empty((b, h, w, cout // 4), dtype=torch.int8, device=x.device)
    e = epilogue

    def ptr(t):
        return None if t is None else t.data_ptr()

    steps = op.steps[bn]
    launch("int8_conv", "tpuseg_int8_conv", x.device, current_stream(x.device),
           x.data_ptr(), op.wm.data_ptr(), e.ws.data_ptr(), ptr(e.b), e.s.data_ptr(),
           e.t.data_ptr(), ptr(e.so), out.data_ptr(), out.stride(2), int(d2s), ptr(pooled),
           POOLS[pool], steps.data_ptr(), op.counts[bn].data_ptr(), steps.shape[1], b, h, w, cin,
           cout, weights.kh, weights.kw, op.wm.shape[1], MODES[e.mode], _ROUTE_CODES[route], bn,
           bw, what=f"int8_conv kernel launch failed ({route} route)")
    LAUNCHES += 1
    ROUTE_LAUNCHES[route] += 1
    LAST_ROUTE = route
    return (out, pooled) if pool else out


def int8_conv(x: torch.Tensor, weights: Int8ConvWeights, epilogue: Epilogue,
              out: Optional[torch.Tensor] = None, d2s: bool = False,
              pool: Optional[str] = None):
    """SAME stride-1 conv of NHWC int8 ``x`` with ``weights``, int32 sums,
    then ``epilogue``: ``(B, H, W, cout)`` int8, or f32 in ``"relu_f32"``.

    The store forms (int8 modes, where :func:`form_problem` finds none):
    ``d2s`` returns ``(B, 2H, 2W, cout / 4)``, channel ``(py*2 + px)*C + c``
    of pixel ``(y, x)`` at pixel ``(2y + py, 2x + px)``; ``out``, a channel
    slice ``buf[..., a:a + cout]`` of a contiguous NHWC int8 buffer of the
    output's height and width, receives the result and is returned; ``pool``
    returns ``(y, pooled)``, ``pooled`` the 2x2/2 max of ``y`` (``"spatial"``,
    ``(B, H/2, W/2, cout)``) or the max over its four phase groups
    (``"phase"``, ``(B, H, W, cout / 4)``)."""
    dev = x.device
    if dev.type == "cpu":
        _check_forms(x, weights, epilogue, out, d2s, pool)
        return _int8_conv_plain(x, weights, epilogue, out, d2s, pool)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv runs on cuda or cpu tensors, not {dev}")
    return _launch(x, weights, epilogue, out=out, d2s=d2s, pool=pool)
