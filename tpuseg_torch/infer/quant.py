"""Post-training int8 quantization of the U-Net forward (serving fast path).

Counterpart of ``tpuseg/infer/quant.py``; read its docstring for the
engine's design (BN folding, int8-resident edges carrying
``(int8 tensor, per-channel scale vector)``, input scales folded into the
weights, max-pool on int8, percentile calibration, ``fp_blocks``, and the
space-to-depth ``int8_blocked`` walk). What is the same here, on purpose:

- the host-side weight folding and quantization are the JAX package's
  numpy, line for line, so the int8 codes are bit-equal to it;
- the calibration file format tag, so the two packages read each other's
  scales files;
- the walk topology and every epilogue's order of float operations.

What PyTorch changes:

- **The int8 conv** is XLA's ``conv_general_dilated`` with int32
  accumulation in the JAX package, its epilogue fused by XLA. Here it is
  :func:`tpuseg_torch.infer.int8_conv.int8_conv` (K3), handed the block's
  epilogue as data: a hand-written implicit-GEMM kernel with the epilogue
  fused on the card, im2col + ``torch._int_mm`` with the same epilogue on
  the CPU.
- **The fp input block** (``enc1a`` under the default ``fp_blocks``, the
  one fp block whose input is the network input) is
  :func:`tpuseg_torch.infer.input_conv.input_conv` (K5): the conv, its
  ReLU, folded BN and requantize in one hand-written kernel on the card,
  on the dense batch in both walks (the blocked walk takes its output
  phase-major), plain PyTorch in the same order of operations on the CPU.
- **The edge ops of the int8 walks** — the 2x2 max-pools, the blocked
  walk's phase max, the skip concats and each deconv's depth-to-space,
  which XLA fused into the jitted predict — are K3's store forms: the last
  block of each encoder level stores its codes into its half of the
  concat buffer and their max beside them, and the deconv stores
  depth-to-space into the other half (:func:`_quantized_raw_fn`). An fp
  block, and a block whose shapes K3's forms do not take on a card
  (:func:`~tpuseg_torch.infer.int8_conv.form_problem`: narrow test
  models), keeps the eager ops.
- **The head and its argmax** of the predict entry point are one kernel
  for up to 8 classes: K2 in the blocked walk, K6 in the dense walk
  (:mod:`tpuseg_torch.infer.head_kernel`), where XLA fused the head block
  and ``predict``'s argmax into one program; the logits entry point keeps
  the eager head.
- **Other fp convs** (calibration, the other ``fp_blocks``) run in float32
  on inputs and weights rounded to the compute dtype — the JAX package's
  bf16 operands with f32 accumulation — with cuDNN's TF32 turned off
  around them, since calibration runs f32 on purpose.
- **Percentile**: ``torch.quantile`` refuses inputs over 2^24 elements (a
  512^2 crop at base 64 is exactly 2^24), so :func:`_percentile` picks the
  order statistics with ``kthvalue`` and interpolates linearly in float32,
  as ``jnp.percentile`` does.
- Eager execution has no trace time: the weights each block needs are
  folded and quantized on its first call and cached on the device.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpuseg_torch.infer.input_conv import input_conv
from tpuseg_torch.infer.int8_conv import (Epilogue, Int8ConvWeights, _d2s, form_problem,
                                          int8_conv)
from tpuseg_torch.models.unet import BN_EPSILON, POOLING_STRIDE, as_dtype

# Ordered block names of the reference graph (model.py:85-146)
CONV_BLOCKS = (
    "enc1a", "enc1b", "enc2a", "enc2b", "enc3a", "enc3b", "enc4a", "enc4b",
    "bottlenecka", "bottleneckb",
    "dec4a", "dec4b", "dec3a", "dec3b", "dec2a", "dec2b", "dec1a", "dec1b",
    "head",
)
DECONV_BLOCKS = ("dec4up", "dec3up", "dec2up", "dec1up")

# Serving defaults of the JAX package (its held-out-corpus sweep).
DEFAULT_FP_BLOCKS = ("enc1a", "head")
DEFAULT_PERCENTILE = 99.9

# Calibration key for the network input (the z-scored image itself)
INPUT_TAP = "input"

Folded = Dict[str, Dict[str, np.ndarray]]


# --- host-side folding and quantization (numpy, as in the JAX package) ---

def _bn_affine(gamma, beta, mean, var):
    """Folded inference-BN: (s, t) with y = x*s + t (ref model.py:36)."""
    s = gamma / np.sqrt(np.asarray(var) + BN_EPSILON)
    t = beta - mean * s
    return np.asarray(s, np.float32), np.asarray(t, np.float32)


def _hwio(weight: torch.Tensor, transposed: bool) -> np.ndarray:
    w = weight.detach().cpu().float().numpy()
    if transposed:  # torch ConvTranspose2d (in, out, kh, kw) -> flax HWIO
        return np.ascontiguousarray(np.flip(w.transpose(2, 3, 0, 1), (0, 1)))
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))  # OIHW -> HWIO


def fold_variables(model_or_state_dict) -> Folded:
    """The port's U-Net (or its ``state_dict``) -> per-block folded
    inference params, in the JAX package's layout: conv blocks
    ``{"w": (kh,kw,cin,cout) f32, "b": (cout,), "s", "t"}``; deconv blocks
    the same minus ``b`` (``w`` as flax's ConvTranspose or 1x1 kernel)."""
    sd = model_or_state_dict
    if isinstance(sd, torch.nn.Module):
        sd = sd.state_dict()

    def arr(key):
        return sd[key].detach().cpu().float().numpy()

    folded: Folded = {}
    for name in CONV_BLOCKS + DECONV_BLOCKS:
        s, t = _bn_affine(arr(f"{name}.bn.weight"), arr(f"{name}.bn.bias"),
                          arr(f"{name}.bn.running_mean"), arr(f"{name}.bn.running_var"))
        if name in CONV_BLOCKS:
            folded[name] = {"w": _hwio(sd[f"{name}.conv.weight"], False),
                            "b": arr(f"{name}.conv.bias"), "s": s, "t": t}
        else:
            w = sd[f"{name}.deconv.weight"]
            # ConvTranspose2d weights are (in, out, 2, 2); the pixel-shuffle
            # form's 1x1 conv is (4*out, in, 1, 1)
            folded[name] = {"w": _hwio(w, transposed=w.shape[-1] == 2), "s": s, "t": t}
    return folded


def quantize_weight(w: np.ndarray, in_scales: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 with the input activation scales
    folded in: ``conv(x_int8, wq) * wscale[cout] ~= conv(x, w)`` where
    ``x = x_int8 * in_scales[cin]``.  Returns ``(wq int8, wscale f32)``.
    """
    w_folded = w * np.asarray(in_scales, np.float32)[:, None]  # (cin, cout) bcast
    amax = np.max(np.abs(w_folded.reshape(-1, w.shape[-1])), axis=0)
    wscale = np.where(amax > 0, amax, 1.0).astype(np.float32) / 127.0
    wq = np.clip(np.round(w_folded / wscale), -127, 127).astype(np.int8)
    return wq, wscale


def _block_weight(w: np.ndarray, cin_groups: Tuple[int, ...]) -> np.ndarray:
    """Blocked equivalent of an odd conv kernel: ``conv(x, w) == d2s(conv(
    s2d(x), wb))`` with SAME padding on both sides; ``cin_groups`` gives the
    concat structure of the input channels (each group is phase-major on
    its own). See ``tpuseg.infer.quant._block_weight``."""
    kh, kw, cin, cout = w.shape
    if kh % 2 != 1 or kw % 2 != 1:
        raise ValueError(f"blocking expects odd kernels, got {kh}x{kw}")
    entries = []
    for po_y in range(2):
        for po_x in range(2):
            po = po_y * 2 + po_x
            for ky in range(kh):
                for kx in range(kw):
                    iy = po_y + ky - kh // 2  # original row offset from 2i
                    ix = po_x + kx - kw // 2
                    entries.append((iy // 2, ix // 2, iy % 2 * 2 + ix % 2,
                                    ky, kx, po))
    qy_min = min(e[0] for e in entries)
    qx_min = min(e[1] for e in entries)
    KH = max(e[0] for e in entries) - qy_min + 1
    KW = max(e[1] for e in entries) - qx_min + 1
    # SAME alignment requires the blocked kernel centered and odd
    assert KH % 2 == 1 and KW % 2 == 1 and qy_min == -(KH // 2) \
        and qx_min == -(KW // 2), (KH, KW, qy_min, qx_min)
    starts = np.concatenate([[0], np.cumsum(cin_groups)])
    assert starts[-1] == cin, (cin_groups, cin)

    def bidx(pi: int, ci: int) -> int:
        g = int(np.searchsorted(starts, ci, side="right")) - 1
        return int(4 * starts[g] + pi * cin_groups[g] + (ci - starts[g]))

    wb = np.zeros((KH, KW, 4 * cin, 4 * cout), np.float32)
    for (qy, qx, pi, ky, kx, po) in entries:
        for ci in range(cin):
            wb[qy - qy_min, qx - qx_min, bidx(pi, ci),
               po * cout:(po + 1) * cout] = w[ky, kx, ci]
    return wb


def _block_weight_deconv(w: np.ndarray, impl: str) -> np.ndarray:
    """Blocked 2x stride-2 deconv == a dense 1x1 conv emitting phase-major
    blocked channels: ``conv_transpose(x, w, s=2) == d2s(conv1x1(x, wb))``;
    conv_transpose places ``x[i,j] @ w[1-dy, 1-dx]`` at phase (dy, dx), the
    pixel_shuffle 1x1 kernel is already phase-major."""
    if impl == "pixel_shuffle":
        return np.asarray(w)
    kh, kw, cin, cout = w.shape
    assert (kh, kw) == (POOLING_STRIDE, POOLING_STRIDE), (kh, kw)
    wb = np.zeros((1, 1, cin, 4 * cout), w.dtype)
    for dy in range(2):
        for dx in range(2):
            po = dy * 2 + dx
            wb[0, 0, :, po * cout:(po + 1) * cout] = w[1 - dy, 1 - dx]
    return wb


# --- device primitives on NHWC tensors ---

@contextlib.contextmanager
def _ieee_f32():
    """cuDNN runs f32 convs in TF32 by default (``allow_tf32``); the folded
    fp walk is f32 on purpose (faithful calibration ranges), so TF32 is
    off inside, and restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """MaxPool 2x2/2 on NHWC (model.py:50-53); valid for fp and int8."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _conv_fp(x: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """SAME conv of NHWC ``x`` with an OIHW f32 ``w`` whose operands are
    rounded to ``dtype``, accumulated and returned in f32."""
    xf = x.to(dtype).float().permute(0, 3, 1, 2)
    with _ieee_f32():
        y = F.conv2d(xf, w.to(dtype).float(), padding=w.shape[-1] // 2)
    return y.permute(0, 2, 3, 1)


def _s2d(x: torch.Tensor) -> torch.Tensor:
    """Space-to-depth: (B, H, W, C) -> (B, H/2, W/2, 4C), phase-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` (linear interpolation, float32 index math)
    through ``kthvalue``, which has no element limit."""
    a = a.reshape(-1)
    n = a.numel()
    nf = np.float32(n)
    pos = np.float32(np.float32(q) / np.float32(100.0)) * (nf - np.float32(1.0))
    lo = int(min(max(np.floor(pos), 0), nf - 1))
    hi = int(min(max(np.ceil(pos), 0), nf - 1))
    hw = np.float32(pos - np.float32(lo))
    lo_v = torch.kthvalue(a, lo + 1).values
    hi_v = lo_v if hi == lo else torch.kthvalue(a, hi + 1).values
    return lo_v * float(np.float32(1.0) - hw) + hi_v * float(hw)


# --- walks ---

def _unet_walk(x, conv_block, deconv_block, pool, concat):
    """The reference graph topology (model.py:85-146) over abstract blocks
    and edge ops; dropout is inference-identity."""

    def pair(name, x):
        return conv_block(f"{name}b", conv_block(f"{name}a", x))

    enc1 = pair("enc1", x)
    enc2 = pair("enc2", pool(enc1))
    enc3 = pair("enc3", pool(enc2))
    enc4 = pair("enc4", pool(enc3))
    bott = pair("bottleneck", pool(enc4))

    def up(x, skip, name):
        x = deconv_block(f"{name}up", x)
        # concat order (skip, up), model.py:117
        return pair(name, concat(skip, x))

    dec4 = up(bott, enc4, "dec4")
    dec3 = up(dec4, enc3, "dec3")
    dec2 = up(dec3, enc2, "dec2")
    dec1 = up(dec2, enc1, "dec1")
    return conv_block("head", dec1)


class _DeviceCache:
    """Per-block constants built on first use and kept on the device of the
    batch that asked for them (eager counterpart of trace-time constants)."""

    def __init__(self):
        self._d: Dict[tuple, object] = {}

    def get(self, key, device: torch.device, make: Callable[[], object]):
        k = (key, device)
        v = self._d.get(k)
        if v is None:
            v = self._d[k] = make()
        return v


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _oihw(w_hwio: np.ndarray, device) -> torch.Tensor:
    return _tensor(np.asarray(w_hwio, np.float32).transpose(3, 2, 0, 1), device)


def _folded_walk(folded: Folded, x: torch.Tensor, deconv_impl: str,
                 dtype: torch.dtype, cache: _DeviceCache, tap=None) -> torch.Tensor:
    """The BN-folded fp forward over the reference graph; ``tap(name, y)``
    (if given) observes every block output. Calibration and the
    parity-anchored logits fn both run exactly this graph."""
    dev = x.device

    def const(name, key, make):
        return cache.get((name, key), dev, make)

    def conv_block(name, x):
        p = folded[name]
        w = const(name, "w", lambda: _oihw(p["w"], dev))
        b, s, t = (const(name, k, lambda k=k: _tensor(p[k], dev)) for k in "bst")
        y = torch.clamp_min(_conv_fp(x, w, dtype) + b, 0.0)
        y = (y * s + t).to(dtype)
        if tap is not None:
            tap(name, y)
        return y

    def deconv_block(name, x):
        p = folded[name]
        wb = const(name, "wb", lambda: _oihw(
            _block_weight_deconv(np.asarray(p["w"], np.float32), deconv_impl), dev))
        s, t = (const(name, k, lambda k=k: _tensor(p[k], dev)) for k in "st")
        y = _d2s(_conv_fp(x, wb, dtype))
        y = (y * s + t).to(dtype)
        if tap is not None:
            tap(name, y)
        return y

    def concat(a, b):
        return torch.cat([a, b], dim=-1)

    return _unet_walk(x, conv_block, deconv_block, _maxpool, concat)


def make_folded_logits_fn(folded: Folded, deconv_impl: str = "conv_transpose",
                          dtype=torch.float32) -> Callable[[torch.Tensor], torch.Tensor]:
    """The folded-fp forward: ``make_folded_logits_fn(fold_variables(m))(x)``
    equals ``m(x)`` in f32 — the anchor the int8 engine is diffed against."""
    dtype = as_dtype(dtype)
    cache = _DeviceCache()

    @torch.inference_mode()
    def logits_fn(x):
        return _folded_walk(folded, x.to(dtype), deconv_impl, dtype, cache).float()

    return logits_fn


def calibrate(folded: Folded, images: Iterable[np.ndarray],
              deconv_impl: str = "conv_transpose",
              percentile: float = DEFAULT_PERCENTILE,
              device="cuda") -> Dict[str, float]:
    """Per-block *output* magnitude ranges (plus the network input's under
    ``INPUT_TAP``) over z-score-normalized calibration images, on
    ``device``: the given percentile of |activations| of the f32 folded
    forward, mean-aggregated across images (max-aggregated for exact-max
    ``percentile=100``). Mismatched images are center-cropped or
    reflect-padded to the first image's x16-padded geometry, as in the JAX
    package."""
    from tpuseg_torch.infer.tiled import _pad_to_multiple

    if not 0.0 < percentile <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got {percentile}")

    def rng(x):
        x = x.abs()
        return x.max() if percentile >= 100.0 else _percentile(x, percentile)

    cache = _DeviceCache()
    per_image: Dict[str, List[float]] = {}
    canon: Optional[Tuple[int, int]] = None
    for img in images:
        arr = np.asarray(img, np.float32)
        if canon is not None and arr.shape[:2] != canon:
            ch, cw = canon
            y0 = max(0, (arr.shape[0] - ch) // 2)
            x0 = max(0, (arr.shape[1] - cw) // 2)
            arr = arr[y0:y0 + ch, x0:x0 + cw]
            if arr.shape[0] < ch or arr.shape[1] < cw:
                pad = [(0, ch - arr.shape[0]), (0, cw - arr.shape[1])]
                pad += [(0, 0)] * (arr.ndim - 2)
                # reflect caps pad width at dim-1; fall back for tiny images
                mode = "reflect" if (pad[0][1] < arr.shape[0]
                                     and pad[1][1] < arr.shape[1]) else "edge"
                arr = np.pad(arr, pad, mode=mode)
        arr, _, _ = _pad_to_multiple(arr)
        canon = canon or arr.shape[:2]
        x = _tensor(arr[None], device)
        taps = {INPUT_TAP: rng(x)}
        with torch.inference_mode():
            _folded_walk(folded, x, deconv_impl, torch.float32, cache,
                         tap=lambda name, y: taps.__setitem__(name, rng(y)))
        for k, v in taps.items():
            per_image.setdefault(k, []).append(float(v))
    if not per_image:
        raise ValueError("calibration needs at least one image")
    agg = max if percentile >= 100.0 else (lambda vs: sum(vs) / len(vs))
    return {k: agg(vs) for k, vs in per_image.items()}


_CALIBRATION_FORMAT = "tpuseg-int8-calibration-v1"  # shared with tpuseg


def save_act_ranges(path: str, act_ranges: Dict[str, float],
                    percentile: Optional[float] = None) -> None:
    """Persist calibrated activation ranges as JSON, in the JAX package's
    format; the write is atomic (temp file + ``os.replace``)."""
    import json
    import os
    import tempfile

    doc = json.dumps({
        "format": _CALIBRATION_FORMAT,
        "percentile": percentile,
        "act_ranges": {k: float(v) for k, v in act_ranges.items()},
    }, indent=2, sort_keys=True) + "\n"
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(doc)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_act_ranges(path: str,
                    expect_percentile: Optional[float] = None
                    ) -> Dict[str, float]:
    """Inverse of :func:`save_act_ranges` (and of the JAX package's); checks
    the format tag and the block-name key set, and warns when the file's
    percentile differs from ``expect_percentile``."""
    import json

    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or doc.get("format") != _CALIBRATION_FORMAT:
        raise ValueError(
            f"{path} is not a tpuseg int8 calibration file "
            f'(expected format tag "{_CALIBRATION_FORMAT}")')
    saved_pct = doc.get("percentile")
    if (expect_percentile is not None and saved_pct is not None
            and float(saved_pct) != float(expect_percentile)):
        print(f"WARNING: {path} was calibrated at percentile {saved_pct}; "
              f"the configured --calibration_percentile {expect_percentile} "
              "is ignored when loading persisted scales — recalibrate "
              "without --calibration_in to change the clip recipe")
    ranges = {k: float(v) for k, v in doc["act_ranges"].items()}
    expected = set(CONV_BLOCKS) | set(DECONV_BLOCKS) | {INPUT_TAP}
    missing = expected - set(ranges)
    unknown = set(ranges) - expected
    if missing or unknown:
        raise ValueError(
            f"{path} does not match the U-Net block set: "
            f"missing={sorted(missing)} unknown={sorted(unknown)}")
    return ranges


def _quantized_raw_fn(folded: Folded, act_ranges: Dict[str, float],
                      fp_blocks: Sequence[str], deconv_impl: str,
                      dtype: torch.dtype, blocked_edges: bool,
                      head_override: Optional[Callable] = None,
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The int8-resident forward shared by the logits and predict entry
    points. Returns f32 logits ``(B, H, W, ncls)``, or — with
    ``blocked_edges`` — phase-major blocked logits ``(B, H/2, W/2,
    4*ncls)``. ``head_override(x, sv)``, when set, replaces the head stage
    of either walk (it is given the dec1b edge, dense or blocked) and its
    return value becomes the walk's."""
    unknown = set(fp_blocks) - set(CONV_BLOCKS) - set(DECONV_BLOCKS)
    if unknown:
        raise ValueError(
            f"fp_blocks entries not in the U-Net block set: {sorted(unknown)}; "
            f"valid names: {CONV_BLOCKS + DECONV_BLOCKS}")
    cache = _DeviceCache()

    def out_scale(name) -> np.float32:
        return np.float32(max(act_ranges[name], 1e-12) / 127.0)

    def vec(name, key, dev, make):
        return cache.get((name, key), dev, lambda: _tensor(make(), dev))

    # Scales divide as 0-dim device tensors: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, which rounds differently
    # from the true division the JAX package does.
    def so_vec(name, dev):
        return vec(name, "so", dev, lambda: np.asarray(out_scale(name)))

    def emit(y, name):
        """Fused epilogue tail: requantize to the block's output range."""
        return torch.clamp(torch.round(y / so_vec(name, y.device)), -127, 127).to(torch.int8)

    def dequant(x, sv, name, key):
        return (x.float() * vec(name, key + "sv", x.device, lambda: sv)).to(dtype)

    def quantize_input(batch):
        """On-the-fly int8 quantization of the fp network input, shared by
        the dense and blocked walks."""
        si = np.float32(max(act_ranges[INPUT_TAP], 1e-12) / 127.0)
        sit = vec(INPUT_TAP, "si", batch.device, lambda: np.asarray(si))
        q = torch.clamp(torch.round(batch.float() / sit), -127, 127)
        return q.to(torch.int8), si

    def input_block(name, batch, blocked: bool):
        """An fp block whose input is the network input (``enc1a`` under
        the default fp_blocks): K5, the conv and its epilogue in one pass,
        on the dense batch and the dense kernel in both walks (``blocked``
        returns the phase-major layout)."""
        p = folded[name]
        dev = batch.device
        w = cache.get((name, "w5"), dev, lambda: _tensor(np.asarray(p["w"], np.float32), dev))
        b_, s_, t_ = (vec(name, k, dev, lambda k=k: p[k]) for k in "bst")
        return input_conv(batch.float().contiguous(), w, b_, s_, t_, so_vec(name, dev), dtype,
                          blocked)

    def conv(name, key, x, sv, w_hwio, bias, s, t, last: bool, **forms):
        """One conv block: the fp form when ``name`` is in fp_blocks (K5
        where its input is the network input), else the int8 conv with its
        epilogue fused, with K3's store ``forms``. ``w_hwio``/``bias``/``s``/
        ``t`` are thunks producing numpy arrays (built once)."""
        if name in fp_blocks and sv is None and not last:
            return input_block(name, x, blocked=False)
        dev = x.device
        b_, s_, t_ = (vec(name, key + k, dev, f) for k, f in
                      (("b", bias), ("s", s), ("t", t)))
        if name in fp_blocks:
            xf = dequant(x, sv, name, key)
            w = cache.get((name, key + "w"), dev, lambda: _oihw(w_hwio(), dev))
            y = torch.clamp_min(_conv_fp(xf, w, dtype) + b_, 0.0) * s_ + t_
            return y if last else emit(y, name)
        wq, wscale = cache.get((name, key + "q"), dev,
                               lambda: quantize_weight(w_hwio(), sv))
        op = cache.get((name, key + "op"), dev, lambda: Int8ConvWeights(wq))
        epi = cache.get((name, key + "epi"), dev, lambda: Epilogue(
            "relu_f32" if last else "relu_requant", vec(name, key + "ws", dev, lambda: wscale),
            b_, s_, t_, None if last else so_vec(name, dev)))
        return int8_conv(x, op, epi, **forms)

    def edge(name, y):
        """An int8 output of block ``name`` and its per-channel scales."""
        return y, np.full(y.shape[-1], out_scale(name), np.float32)

    def fuses(name, x, cout, mode, **forms):
        """Whether block ``name`` runs its edge op as K3's store ``forms``:
        an int8 block whose shapes the wrapper takes on ``x``'s device."""
        return name not in fp_blocks and form_problem(x, cout, mode, **forms) is None

    def conv_block(name, edge_in, **forms):
        x, sv = edge_in
        if name == "head" and head_override is not None:
            return head_override(x, sv)
        p = folded[name]
        if sv is None and name not in fp_blocks:  # quantize the fp input
            x, si = quantize_input(x)
            sv = np.full(p["w"].shape[-2], si, np.float32)
        last = name == "head"
        y = conv(name, "", x, sv, lambda: p["w"], lambda: p["b"],
                 lambda: p["s"], lambda: p["t"], last, **forms)
        if last:
            return y
        return (edge(name, y[0]), edge(name, y[1])) if forms.get("pool") else edge(name, y)

    def deconv_block(name, edge_in, blocked_out=False, out=None):
        """A 2x2/stride-2 deconv is a 1x1 conv to phase-major 4*cout
        channels plus depth-to-space (exact for int8 codes too); with
        ``blocked_out`` the phase-major output is returned as it is. An int8
        deconv stores the depth-to-space itself (K3's ``d2s`` form), into
        ``out`` where given."""
        x, sv = edge_in
        p = folded[name]
        w = p["w"]
        dev = x.device
        s4 = vec(name, "s4", dev, lambda: np.tile(p["s"], 4))
        t4 = vec(name, "t4", dev, lambda: np.tile(p["t"], 4))
        if name in fp_blocks:
            xf = x if sv is None else dequant(x, sv, name, "")
            wt = cache.get((name, "wb"), dev, lambda: _oihw(
                _block_weight_deconv(np.asarray(w, np.float32), deconv_impl), dev))
            y = emit(_conv_fp(xf, wt, dtype) * s4 + t4, name)
            return edge(name, y if blocked_out else _d2s(y))
        # quantize the DENSE kernel first, then reorder its int8 codes
        # (per-output-channel amax over all 2x2 taps, as the JAX engine)
        def qb():
            wq, wscale = quantize_weight(w, sv)
            if deconv_impl != "pixel_shuffle":
                wscale = np.tile(wscale, 4)
            return _block_weight_deconv(wq, deconv_impl), wscale

        wqb, wscale = cache.get((name, "qb"), dev, qb)
        op = cache.get((name, "op"), dev, lambda: Int8ConvWeights(wqb))
        epi = cache.get((name, "epi"), dev, lambda: Epilogue(
            "affine_requant", vec(name, "ws", dev, lambda: wscale), None, s4, t4,
            so_vec(name, dev)))
        d2s = not blocked_out
        if d2s and out is None and not fuses(name, x, op.cout, epi.mode, d2s=True):
            return edge(name, _d2s(int8_conv(x, op, epi)))  # the requantize commutes
        return edge(name, int8_conv(x, op, epi, out=out, d2s=d2s))

    def pool(edge_in):
        x, sv = edge_in
        return _maxpool(x), sv  # quantization is monotone: pool commutes

    def phase_max(edge_in):
        """pool1 on the blocked layout: max over the 4 phases per blocked
        pixel — exactly maxpool 2x2/2 (every phase shares the scale)."""
        x, sv = edge_in
        c = x.shape[-1] // 4
        y = torch.maximum(torch.maximum(x[..., :c], x[..., c:2 * c]),
                          torch.maximum(x[..., 2 * c:3 * c], x[..., 3 * c:]))
        return y, sv[:c]

    def concat(a, b):
        (xa, sa), (xb, sb) = a, b
        # branches keep their own scales; the consumer's folded weights
        # absorb the concatenated per-channel scale vector
        return torch.cat([xa, xb], dim=-1), np.concatenate([sa, sb])

    def skip_and_pool(name, edge_in, ca, ctot, kind="spatial", block=conv_block):
        """The last block of an encoder level (``Ca`` output channels):
        returns the skip of the concat (skip, the deconv's output) as ``(y,
        scales, buffer)`` and the pooled ``y`` (``kind``: the 2x2 max, or
        the blocked walk's phase max), the next level's input. An int8 block
        stores its codes into channels [0, Ca) of the concat buffer [B, H,
        W, ctot] and the pooled codes beside them in one K3 launch; the
        deconv fills channels [Ca, ctot) later (:func:`up_concat`)."""
        x = edge_in[0]
        if not fuses(name, x, ca, "relu_requant", ctot=ctot, pool=kind):
            y = block(name, edge_in)
            return (*y, None), (pool if kind == "spatial" else phase_max)(y)
        buf = x.new_empty((*x.shape[:3], ctot))
        y, pooled = block(name, edge_in, out=buf[..., :ca], pool=kind)
        return (*y, buf), pooled

    def encoder(x, levels):
        """Encoder ``levels``: the last one's pooled output and each one's
        skip."""
        skips = []
        for k in levels:
            ca = folded[f"enc{k}b"]["w"].shape[-1]
            skip, x = skip_and_pool(f"enc{k}b", conv_block(f"enc{k}a", x), ca,
                                    ca + folded[f"dec{k}up"]["s"].shape[0])
            skips.append(skip)
        return x, skips

    def up_concat(name, edge_in, skip, blocked_out=False):
        """The deconv ``name`` and the concat (skip, its output): an int8
        deconv stores into the skip's concat buffer, where its producer made
        one; an fp deconv's output is copied there; without a buffer the
        two are concatenated."""
        y, sa, buf = skip
        if buf is None:
            return concat((y, sa), deconv_block(name, edge_in, blocked_out))
        ca = y.shape[-1]
        if fuses(name, edge_in[0], 4 * folded[name]["s"].shape[0], "affine_requant",
                 ctot=buf.shape[-1], d2s=not blocked_out):
            _, sb = deconv_block(name, edge_in, blocked_out, out=buf[..., ca:])
        else:
            up_y, sb = deconv_block(name, edge_in, blocked_out)
            buf[..., ca:].copy_(up_y)
        return buf, np.concatenate([sa, sb])

    def pair(name, x):
        return conv_block(f"{name}b", conv_block(f"{name}a", x))

    if not blocked_edges:
        def logits_fn(batch):
            """The reference graph (``_unet_walk``'s topology) with each
            skip's concat buffer made by its producer."""
            x, skips = encoder((batch, None), range(1, 5))
            x = pair("bottleneck", x)
            for k in range(4, 0, -1):
                x = pair(f"dec{k}", up_concat(f"dec{k}up", x, skips[k - 1]))
            return conv_block("head", x)
        return logits_fn

    # ---- blocked-edge walk: the C=64 stages run on dense (H/2, W/2, 4C)
    # tensors, the pyramid middle (enc2 .. dec2) runs the plain closures ----

    def blocked_conv_block(name, edge_in, cin_groups, **forms):
        x, sv = edge_in
        p = folded[name]
        last = name == "head"
        y = conv(name, "blk", x, sv, lambda: _block_weight(p["w"], cin_groups),
                 lambda: np.tile(p["b"], 4), lambda: np.tile(p["s"], 4),
                 lambda: np.tile(p["t"], 4), last, **forms)
        if last:
            return y  # blocked logits
        return (edge(name, y[0]), edge(name, y[1])) if forms.get("pool") else edge(name, y)

    def blocked_logits_fn(batch):
        nc = batch.shape[-1]
        f = folded["enc1b"]["w"].shape[2]  # base feature width
        if "enc1a" in fp_blocks:
            enc1a = (input_block("enc1a", batch, blocked=True),
                     np.full(4 * f, out_scale("enc1a"), np.float32))
        else:
            q, si = quantize_input(batch)
            enc1a = blocked_conv_block(
                "enc1a", (_s2d(q), np.full(4 * nc, si, np.float32)), (nc,))
        # enc1b on the blocked layout: the skip of dec1a's [B, H/2, W/2, 8F]
        # concat buffer, which the blocked dec1up fills, and its phase max
        skip1, x = skip_and_pool("enc1b", enc1a, 4 * f, 8 * f, "phase",
                                 lambda *a, **forms: blocked_conv_block(*a, (f,), **forms))
        x, skips = encoder(x, range(2, 5))
        skips = [skip1] + skips
        x = pair("bottleneck", x)
        for k in range(4, 1, -1):
            x = pair(f"dec{k}", up_concat(f"dec{k}up", x, skips[k - 1]))
        # dense H/2 -> blocked, into dec1a's concat buffer
        cat = up_concat("dec1up", x, skip1, blocked_out=True)
        d1 = blocked_conv_block(
            "dec1b", blocked_conv_block("dec1a", cat, (f, f)), (f,))
        if head_override is not None:
            return head_override(*d1)
        return blocked_conv_block("head", d1, (f,))

    return blocked_logits_fn


def make_quantized_logits_fn(folded: Folded, act_ranges: Dict[str, float],
                             fp_blocks: Sequence[str] = DEFAULT_FP_BLOCKS,
                             deconv_impl: str = "conv_transpose",
                             dtype=torch.bfloat16,
                             blocked_edges: bool = False,
                             ) -> Callable[[torch.Tensor], torch.Tensor]:
    """NHWC batch -> f32 logits through the int8-resident graph (blocked
    logits are depth-to-spaced back, so the contract is unchanged)."""
    raw = _quantized_raw_fn(folded, act_ranges, fp_blocks, deconv_impl,
                            as_dtype(dtype), blocked_edges)

    @torch.inference_mode()
    def logits_fn(batch):
        out = raw(batch)
        return _d2s(out) if blocked_edges else out

    return logits_fn


def make_quantized_predict_fn(folded: Folded, act_ranges: Dict[str, float],
                              fp_blocks: Sequence[str] = DEFAULT_FP_BLOCKS,
                              deconv_impl: str = "conv_transpose",
                              dtype=torch.bfloat16,
                              blocked_edges: bool = False,
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Serving entry point: NHWC batch -> int32 argmax labels, the contract
    of ``tiled.make_predict_fn``. The head and its argmax run as one kernel
    (the CUDA kernel on the card) for up to 8 classes: with
    ``blocked_edges`` K2 (:func:`~tpuseg_torch.infer.head_kernel.blocked_head_argmax`,
    with the per-phase argmax and the depth-to-space), else K6
    (:func:`~tpuseg_torch.infer.head_kernel.dense_head_argmax`, for heads of
    ``C % 16 == 0`` input channels). Other heads take the conv head plus an
    argmax, as in the JAX package."""
    from tpuseg_torch.infer.head_kernel import (blocked_head_argmax, dense_head_argmax,
                                                dense_head_eligible, head_kernel_eligible)

    dtype = as_dtype(dtype)
    override = None
    w = folded["head"]["w"]  # [1, 1, feats, ncls]
    feats, ncls = w.shape[2], w.shape[3]
    eligible = head_kernel_eligible(ncls) if blocked_edges else dense_head_eligible(ncls, feats)
    if eligible:
        # the head as the kernel takes it: [O, K] weights and (b, s, t,
        # wscale) rows, for the 4 phases of a blocked pixel or one pixel
        reps = 4 if blocked_edges else 1
        wk = _block_weight(w, (feats,)) if blocked_edges else w  # [1, 1, K, O]
        b, s, t = (np.tile(folded["head"][k], reps).astype(np.float32) for k in "bst")
        fp = "head" in fp_blocks
        consts = _DeviceCache()

        def head_consts(sv, dev):
            if fp:
                wt = torch.from_numpy(np.ascontiguousarray(wk[0, 0].T)).to(dtype)
                epi = np.stack([b, s, t, np.ones_like(b)])
            else:
                wq, wscale = quantize_weight(wk, sv)
                wt = torch.from_numpy(np.ascontiguousarray(wq[0, 0].T))
                epi = np.stack([b, s, t, wscale.astype(np.float32)])
            svt = None if sv is None else _tensor(np.asarray(sv, np.float32), dev)
            return svt, wt.to(dev), _tensor(epi, dev)

        head = blocked_head_argmax if blocked_edges else dense_head_argmax

        def override(x, sv):
            svt, wt, epi = consts.get("head", x.device, lambda: head_consts(sv, x.device))
            return head(x, svt, wt, epi, ncls, fp=fp)

    raw = _quantized_raw_fn(folded, act_ranges, fp_blocks, deconv_impl,
                            dtype, blocked_edges, head_override=override)

    @torch.inference_mode()
    def predict(batch):
        out = raw(batch)
        if override is not None:
            return out  # the kernel already returned int32 labels
        if not blocked_edges:
            return torch.argmax(out, dim=-1).to(torch.int32)
        b, h, w_, c4 = out.shape
        lbl = torch.argmax(out.reshape(b, h, w_, 4, c4 // 4), dim=-1)
        # lbl is (b, h, w, 4) = blocked labels with C=1 per phase
        return _d2s(lbl.to(torch.int32))[..., 0]

    return predict


def quantized_predict_from_checkpoint(
        model, calib_images: List[np.ndarray],
        fp_blocks: Sequence[str] = DEFAULT_FP_BLOCKS,
        percentile: float = DEFAULT_PERCENTILE,
        blocked_edges: bool = False):
    """One-call serving path: fold, calibrate on the model's device, build
    the int8 predict_fn."""
    device = next(model.parameters()).device
    folded = fold_variables(model)
    ranges = calibrate(folded, calib_images, deconv_impl=model.deconv_impl,
                       percentile=percentile, device=device)
    return make_quantized_predict_fn(folded, ranges, fp_blocks=fp_blocks,
                                     deconv_impl=model.deconv_impl,
                                     blocked_edges=blocked_edges)
