"""Whole-image inference: batched small images and halo-tiled large ones.

Counterpart of ``tpuseg/infer/tiled.py`` (reference ``UNet/inference.py:
27-173``). The geometry is the JAX package's, line for line: one fixed
tile shape per image with slide-to-fit edge windows, a zone of
responsibility of ``tile - 2*radius`` around the ERF-measured radius,
reflect padding to x16, the same trim order. What changes with PyTorch:

- the image crosses to the device in its native dtype, the z-score
  (with the reference's std<=1 guard) runs there, tiles are cut, run in
  ``batch_size`` chunks by a Python loop (``lax.map`` in JAX) and stitched
  on the device, and the mask crosses back; on one card the crossings are
  a pipeline of row bands that overlaps the predict calls (``PIPELINE``);
- eager execution needs no program cache and no static-shape padding: a
  short last chunk simply runs as a smaller batch;
- ``devices`` (a list) shards each group of ``batch_size x len(devices)``
  tiles over the entries, one chunk of ``batch_size`` on each entry's
  replica of the predict function (the JAX package's tile sharding over a
  mesh). The chunks are launched from this thread in turn, so the cards
  overlap, and gathered in order. With ``devices`` every chunk is full: the
  last group is padded by repeating the first tiles, as the JAX package
  pads its mesh, so one entry and several run the same chunks and give the
  same masks. Replicas are per entry, not per distinct device.

:func:`inference_tiled_streaming` segments tiled-BigTIFF slides larger than
host RAM with the same geometry, as a rolling strip of rows on the device;
its masks equal :func:`inference_tiled`'s given the same statistics.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuseg_torch import RADIUS, SIZE_FACTOR
from tpuseg_torch.utils.profiling import span

TILE_SIZE = 1024  # inference.py:24
# auto-tile search ceiling, kept from the JAX package (sized for a TPU
# v5e's memory there; the H100 envelope is not measured yet)
MAX_AUTO_TILE = 1536

PredictFn = Callable[[torch.Tensor], torch.Tensor]

_IMAGES = itertools.count()  # numbers each inference_tiled call's span

# What the last inference_tiled pass on one device overlapped (a pass over
# ``devices`` leaves zeros): its upload bands, the predict calls queued
# before the compute stream waited for the last band, its download bands,
# and those queued before the last predict call.
PIPELINE: Dict[str, int] = {"upload_bands": 0, "early_calls": 0, "download_bands": 0,
                            "early_downloads": 0}


def max_auto_tile(per_device_batch: int) -> int:
    """Tile cap for auto-tile at a given per-device batch: a larger batch
    shrinks the tile so ``batch x tile^2`` stays inside the envelope the
    1536 ceiling was set for; smaller batches do not raise the cap."""
    budget = 8 * MAX_AUTO_TILE * MAX_AUTO_TILE  # per-device pixels
    cap = int((budget / max(1, per_device_batch)) ** 0.5)
    return min(MAX_AUTO_TILE, cap // SIZE_FACTOR * SIZE_FACTOR)


def choose_tile_size(height: int, width: int, radius: int = RADIUS,
                     min_tile: int = 512, max_tile: int = MAX_AUTO_TILE,
                     chunk: int = 8) -> int:
    """Pick the tile size minimizing computed tile slots for one image:
    multiples of 16 minimizing ``ceil(n_tiles/chunk) * chunk * tile^2``,
    ties toward smaller tiles (``tpuseg.infer.tiled.choose_tile_size``)."""
    best = None
    lo = max(min_tile, ((3 * radius + SIZE_FACTOR - 1) // SIZE_FACTOR) * SIZE_FACTOR)
    for tile in range(lo, max_tile + 1, SIZE_FACTOR):
        zor = tile - 2 * radius
        if zor < radius:
            continue
        n_tiles = -(-height // zor) * (-(-width // zor))
        slots = -(-n_tiles // chunk) * chunk
        key = (slots * tile * tile, tile)
        if best is None or key < best[0]:
            best = (key, tile)
    if best is None:
        raise ValueError(
            f"no valid tile size in [{lo}, {max_tile}] for radius {radius}")
    return best[1]


def _pad_to_multiple(img: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """Reflect-pad bottom/right so H,W are multiples of 16 (inference.py:29-47)."""
    pad_y = (-img.shape[0]) % SIZE_FACTOR
    pad_x = (-img.shape[1]) % SIZE_FACTOR
    if img.ndim == 2:
        img = img[..., None]
    if pad_x > 0 or pad_y > 0:
        img = np.pad(img, ((0, pad_y), (0, pad_x), (0, 0)), mode="reflect")
    return img, pad_y, pad_x


def make_predict_fn(model: torch.nn.Module) -> PredictFn:
    """NHWC float batch -> int32 argmax labels, on the model's device."""

    @torch.inference_mode()
    def predict(batch: torch.Tensor) -> torch.Tensor:
        return torch.argmax(model(batch), dim=-1).to(torch.int32)

    return predict


def make_softmax_fn(model: torch.nn.Module) -> PredictFn:
    """NHWC float batch -> softmax probabilities (reference-contract output)."""

    @torch.inference_mode()
    def softmax(batch: torch.Tensor) -> torch.Tensor:
        return torch.softmax(model(batch), dim=-1)

    return softmax


def _as_device(d) -> torch.device:
    """``d`` as a device with an index (``cuda`` is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _shards(predict_fn, device, devices):
    """``(devices, predict functions, pad)`` of one dispatch: ``device``
    alone with ``predict_fn`` and short last chunks, or each entry of
    ``devices`` with its replica — ``predict_fn`` is then one callable for
    every entry or a sequence with one per entry — and full chunks."""
    if devices is None:
        return [_as_device(device)], [predict_fn], False
    devices = [_as_device(d) for d in devices]
    fns = [predict_fn] * len(devices) if callable(predict_fn) else list(predict_fn)
    if not devices or len(fns) != len(devices):
        raise ValueError(f"{len(fns)} predict functions for {len(devices)} devices")
    return devices, fns, True


def _host_tensor(img: np.ndarray) -> torch.Tensor:
    """``img``'s bits as a host tensor in the dtype that ships: native
    where torch has the type, uint16 (the microscopy corpus' type, which
    has no CUDA arithmetic in torch) as its int16 bits, float32 otherwise."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16:
        return torch.from_numpy(img.view(np.int16))
    if img.dtype in (np.uint8, np.int8, np.int16, np.int32, np.float32):
        return torch.from_numpy(img)
    return torch.from_numpy(img.astype(np.float32))


def _widen(t: torch.Tensor, uint16: bool) -> torch.Tensor:
    """float32 pixels from a shipped tensor; uint16 bits are masked back to
    0..65535."""
    if uint16:
        return (t.to(torch.int32) & 0xFFFF).to(torch.float32)
    return t.to(torch.float32)


def _to_device(img: np.ndarray, device) -> torch.Tensor:
    """Ship ``img`` in its native dtype and widen it on the device."""
    return _widen(_host_tensor(img).to(device), img.dtype == np.uint16)


def _zscore(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """imagereader.py:33-66 with its std<=1 mean-shift-only guard;
    ``mean``/``std`` broadcast over the trailing channel axis."""
    centered = x - mean
    return torch.where(std <= 1.0, centered, centered / std)


def _check_tile_geometry(tile_size: int, radius: int, zor: int) -> None:
    """User-facing geometry validation: ValueError with the rule named."""
    if tile_size % SIZE_FACTOR or radius % SIZE_FACTOR:
        raise ValueError(
            f"tile_size and radius must be multiples of {SIZE_FACTOR} "
            f"(4 pool/2 stages), got tile_size={tile_size} radius={radius}")
    if zor < radius:
        raise ValueError(
            f"tile size too small for the receptive-field halo: zone "
            f"{zor} < radius {radius} (need tile_size >= 3*radius)")


def _zor_placements(height: int, width: int, zor: int, tile_size: int,
                    radius: int, clamp_h: int, clamp_w: int,
                    ) -> List[Tuple[int, int, int, int, int, int]]:
    """The halo/zone grid: ``(zone_y, zone_x, zone_y_end, zone_x_end,
    window_y, window_x)`` per tile, zones clamped to (height, width),
    windows slid-to-fit inside (clamp_h, clamp_w)."""
    placements = []
    for i in range(0, height, zor):
        for j in range(0, width, zor):
            y_end_z = min(i + zor, height)
            x_end_z = min(j + zor, width)
            y_st = min(max(i - radius, 0), clamp_h - tile_size)
            x_st = min(max(j - radius, 0), clamp_w - tile_size)
            placements.append((i, j, y_end_z, x_end_z, y_st, x_st))
    return placements


def inference_single(img: np.ndarray, predict_fn: PredictFn, device="cuda") -> np.ndarray:
    """Small-image path (inference.py:139-173): pad to x16, one forward,
    argmax, unpad. ``img`` is taken as already normalized."""
    if img.ndim not in (2, 3):
        raise IOError("Invalid number of dimensions for input image. "
                      "Expecting HW or HWC dimension ordering.")
    img, pad_y, pad_x = _pad_to_multiple(img)
    pred = predict_fn(_to_device(img[None], device))[0].cpu().numpy()
    return pred[:pred.shape[0] - pad_y, :pred.shape[1] - pad_x]


def inference_single_batch(imgs: List[np.ndarray], predict_fn: PredictFn,
                           batch_size: int = 8, stats=None,
                           device="cuda", devices=None) -> List[np.ndarray]:
    """Batched small-image path: same-shape images run ``batch_size`` at a
    time with the z-score fused on the device, so raw integer pixels ship.
    ``stats`` are per-image ``zscore_stats`` pairs (computed here if not
    given). With ``devices``, groups of ``batch_size x len(devices)``
    images shard over them, a short group padded by repeating its last
    image (the module docstring)."""
    from tpuseg_torch.data.preprocess import zscore_stats

    if not imgs:
        return []
    if any(im.shape != imgs[0].shape for im in imgs):
        raise ValueError(
            f"inference_single_batch needs same-shape images, got "
            f"{sorted({im.shape for im in imgs})}")
    if stats is None:
        stats = [zscore_stats(im) for im in imgs]
    elif len(stats) != len(imgs):
        raise ValueError(f"{len(stats)} stats for {len(imgs)} images")
    padded = [_pad_to_multiple(im) for im in imgs]
    pad_y, pad_x = padded[0][1], padded[0][2]
    devs, fns, pad = _shards(predict_fn, device, devices)
    group_size = batch_size * len(devs)

    preds: List[np.ndarray] = []
    for s in range(0, len(padded), group_size):
        group = [p[0] for p in padded[s:s + group_size]]
        gstats = list(stats[s:s + group_size])
        k = len(group)
        while pad and len(group) < group_size:
            group.append(group[-1])
            gstats.append(gstats[-1])
        outs = []
        for i, (d, fn) in enumerate(zip(devs, fns)):
            part = slice(i * batch_size, (i + 1) * batch_size)
            mean = torch.from_numpy(np.stack([m for m, _ in gstats[part]]).astype(np.float32))
            std = torch.from_numpy(np.stack([sd for _, sd in gstats[part]]).astype(np.float32))
            x = _zscore(_to_device(np.stack(group[part]), d), mean.to(d)[:, None, None, :],
                        std.to(d)[:, None, None, :])
            outs.append(fn(x))
        preds.extend(np.concatenate([o.cpu().numpy() for o in outs])[:k])

    h, w = preds[0].shape
    return [p[:h - pad_y, :w - pad_x] for p in preds]


def _predict_call(fn, img: torch.Tensor, windows, tile_size: int) -> torch.Tensor:
    """One predict call of ``fn`` on the windows at ``(window_y,
    window_x)`` of the device image ``img``."""
    with span("tiled.windows"):
        x = torch.stack([img[y_st:y_st + tile_size, x_st:x_st + tile_size]
                         for (y_st, x_st) in windows])
    with span("tiled.predict"):
        return fn(x)


def _forward_tiles(shards, padded: torch.Tensor, windows, tile_size: int,
                   chunk: int) -> List[torch.Tensor]:
    """Cut the windows at ``(window_y, window_x)`` out of the device image
    and run them ``chunk`` at a time on each of ``shards`` (from
    :func:`_shards`) in turn; returns the chunks' labels, on ``padded``'s
    device, at least ``n_tiles`` tiles of ``(tile, tile)`` in all (pad
    tiles last)."""
    devs, fns, pad = shards
    group = chunk * len(devs)
    if pad:  # repeat the first windows up to whole groups
        windows = list(windows) + [windows[i % len(windows)]
                                   for i in range((-len(windows)) % group)]
    images = {padded.device: padded}  # the image on each shard's device
    preds = []
    for s in range(0, len(windows), group):
        outs = []
        for i, (d, fn) in enumerate(zip(devs, fns)):
            img = images.get(d)
            if img is None:
                img = images[d] = padded.to(d)
            outs.append(_predict_call(fn, img, windows[s + i * chunk:s + (i + 1) * chunk],
                                      tile_size))
        preds.extend(o.to(padded.device) for o in outs)
    return preds


def _stitch(mask: torch.Tensor, placements, preds: torch.Tensor) -> None:
    """Write each tile's trimmed zone of ``preds`` (one tile a placement,
    in order) into ``mask``."""
    for k, (i, j, y_end_z, x_end_z, y_st, x_st) in enumerate(placements):
        mask[i:y_end_z, j:x_end_z] = preds[k, i - y_st:y_end_z - y_st,
                                           j - x_st:x_end_z - x_st]


def _device_stats(norm_stats, device):
    """``norm_stats`` as per-channel ``(mean, std)`` tensors on ``device``,
    or ``(None, None)``."""
    if norm_stats is None:
        return None, None
    return tuple(torch.from_numpy(np.asarray(s, np.float32).reshape(-1)).to(device)
                 for s in norm_stats)


class _Plan(NamedTuple):
    """The band and zone schedule of one pass (:func:`_plan`)."""

    calls: List[Tuple[int, int]]  # the tiles [s, e) of each predict call
    reads: List[int]  # the rows each call's windows read lie below this
    bands: List[Tuple[int, int]]  # the upload's row bands [r0, r1), in order
    needs: List[int]  # per call, how many bands (a prefix) it waits for
    downs: List[Tuple[int, int]]  # per call, the mask rows [a, z) it finishes


def _plan(placements, tile_size: int, chunk: int, crop_h: int) -> _Plan:
    """Which rows each predict call reads and which zone rows it finishes.

    Calls take the (row-major) placements ``chunk`` at a time. The upload's
    bands end at the calls' read limits, so a call waits only for the rows
    its windows read. Zone rows finish in order, so the mask rows that are
    whole after a call are a prefix: ``downs[c]`` is what call ``c`` adds
    to it, clipped to the first ``crop_h`` rows (empty where it finishes no
    zone row)."""
    n = len(placements)
    calls = [(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    reads = list(itertools.accumulate(
        (max(p[4] for p in placements[s:e]) + tile_size for s, e in calls), max))
    cuts = sorted(set(reads))
    bands = list(zip([0] + cuts[:-1], cuts))
    needs = [cuts.index(r) + 1 for r in reads]
    last = {}  # zone row -> (index of its last tile, its end row)
    for k, p in enumerate(placements):
        last[p[0]] = (k, p[2])
    downs, done = [], 0
    for _, e in calls:
        whole = max([end for k, end in last.values() if k < e], default=0)
        downs.append((min(done, crop_h), min(whole, crop_h)))
        done = whole
    return _Plan(calls, reads, bands, needs, downs)


def _banded_pass(host: torch.Tensor, uint16: bool, predict_fn, placements, tile_size: int,
                 chunk: int, norm_stats, device: torch.device, mask_shape, crop,
                 mask_dtype, device_output: bool):
    """One device's pass as a copy pipeline (:func:`inference_tiled`).

    On a card each band is staged into pinned memory and sent without
    blocking on an upload stream; the current (compute) stream waits for a
    band's copy only where it z-scores that band, just before the first
    call that reads it. The first call's band goes first; once a call is
    queued, the next call's bands are staged and sent, so they cross while
    the call runs. Each call is stitched at once; the mask rows it
    finishes go down on a download stream into pinned memory behind an
    event of the compute stream, and land in the numpy result while the
    card runs the next call. Neither copy stream waits for the other. Off
    a card the same schedule runs in order, with no copies."""
    plan = _plan(placements, tile_size, chunk, crop[0])
    on_card = device.type == "cuda"
    mean, std = _device_stats(norm_stats, device)
    image = torch.empty(host.shape, dtype=torch.float32, device=device)
    mask = torch.zeros(mask_shape, dtype=mask_dtype, device=device)
    raw, ups = host, []  # the shipped image on the device; each band's copy event
    if on_card:
        compute = torch.cuda.current_stream(device)
        up, down = torch.cuda.Stream(device), torch.cuda.Stream(device)
        # the upload stream writes memory that work still queued on the
        # compute stream may have freed: it starts behind that work
        up.wait_stream(compute)
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        raw = torch.empty(host.shape, dtype=host.dtype, device=device)
        raw.record_stream(up)
        mask.record_stream(down)
    if not device_output:
        result = torch.from_numpy(np.empty(crop, np.uint8 if mask_dtype == torch.uint8
                                           else np.int32))
        landing = torch.empty((crop[0], mask_shape[1]), dtype=mask_dtype,
                              pin_memory=True) if on_card else mask
    pending = []  # download bands on their way: (a, z, event)

    def upload(b):
        r0, r1 = plan.bands[b]
        with span("tiled.upload"):
            if on_card:
                staged[r0:r1].copy_(host[r0:r1])
                with torch.cuda.stream(up):
                    raw[r0:r1].copy_(staged[r0:r1], non_blocking=True)
                ups.append(up.record_event())
        PIPELINE["upload_bands"] += 1

    def normalize(b):
        r0, r1 = plan.bands[b]
        with span("tiled.zscore"):
            if on_card:
                compute.wait_event(ups[b])
            x = _widen(raw[r0:r1], uint16)
            image[r0:r1] = x if mean is None else _zscore(x, mean, std)

    def download(a, z):
        with span("tiled.download"):
            event = None
            if on_card:
                down.wait_event(compute.record_event())
                with torch.cuda.stream(down):
                    landing[a:z].copy_(mask[a:z], non_blocking=True)
                event = down.record_event()
            pending.append((a, z, event))
        PIPELINE["download_bands"] += 1

    def land(n):
        with span("tiled.land"):
            for a, z, event in pending[:n]:
                if event is not None:
                    event.synchronize()
                result[a:z] = landing[a:z, :crop[1]]
            del pending[:n]

    issued = ready = 0  # bands staged and sent; bands z-scored
    last = len(plan.calls) - 1
    for c, (s, e) in enumerate(plan.calls):
        while issued < plan.needs[c]:
            upload(issued)
            issued += 1
        while ready < plan.needs[c]:
            normalize(ready)
            ready += 1
        PIPELINE["early_calls"] += ready < len(plan.bands)
        preds = _predict_call(predict_fn, image, [p[4:] for p in placements[s:e]], tile_size)
        while issued < plan.needs[min(c + 1, last)]:
            upload(issued)
            issued += 1
        with span("tiled.stitch"):
            _stitch(mask, placements[s:e], preds)
        earlier = len(pending)
        a, z = plan.downs[c]
        if z > a and not device_output:
            download(a, z)
            PIPELINE["early_downloads"] += c < last
        if earlier:
            land(earlier)  # the earlier calls' rows, while this call runs
    if device_output:
        return mask[:crop[0], :crop[1]]
    land(len(pending))
    return result.numpy()


def _whole_pass(img: np.ndarray, shards, placements, tile_size: int, chunk: int,
                norm_stats, device, mask_shape, crop, mask_dtype, device_output: bool):
    """The pass over ``devices``: the whole image up at once, the tiles
    sharded (:func:`_forward_tiles`), the mask stitched on ``device`` and
    brought down at once."""
    with span("tiled.upload"):
        padded = _to_device(img, device)
    if norm_stats is not None:
        with span("tiled.zscore"):
            padded = _zscore(padded, *_device_stats(norm_stats, device))
    preds = _forward_tiles(shards, padded, [p[4:] for p in placements], tile_size, chunk)
    with span("tiled.stitch"):
        mask = torch.zeros(mask_shape, dtype=mask_dtype, device=padded.device)
        _stitch(mask, placements, torch.cat(preds))
    with span("tiled.download"):
        mask = mask[:crop[0], :crop[1]]
        return mask if device_output else mask.cpu().numpy()


def inference_tiled(
    img: np.ndarray,
    predict_fn: PredictFn,
    tile_size: int = TILE_SIZE,
    radius: int = RADIUS,
    batch_size: int = 8,
    num_classes: Optional[int] = None,
    norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    device="cuda",
    device_output: bool = False,
    devices=None,
):
    """Large-image path (inference.py:27-136): ZoR grid with ERF halos,
    fixed-shape slide-to-fit windows, batched device execution; with
    ``devices``, tile groups sharded over them (the module docstring) and
    the mask stitched on ``device``.

    On one device the pass is a copy pipeline (:func:`_banded_pass`): the
    image goes up in row bands, each predict call waits only for the rows
    its windows read, and finished zone rows come down while later calls
    run; ``PIPELINE`` counts what overlapped. With ``devices`` the image
    goes up, and the mask comes down, whole.

    ``norm_stats`` (per-channel ``(mean, std)`` from ``zscore_stats``): when
    given, ``img`` ships in its native dtype and the z-score runs on the
    device; otherwise ``img`` is taken as already normalized.

    Returns the mask as a numpy array of its own, uint8 when
    ``num_classes <= 256`` was given (the device emits bytes — a quarter
    of the transfer), int32 otherwise; with ``device_output`` as the
    cropped tensor on the device, for callers that keep post-processing
    (metrics, encoding) there.
    """
    with span("tiled.image", next(_IMAGES)):
        if img.ndim not in (2, 3):
            raise IOError("Invalid number of dimensions for input image. "
                          "Expecting HW or HWC dimension ordering.")
        with span("tiled.prepare"):
            img, pad_y, pad_x = _pad_to_multiple(img)
            height, width = img.shape[0], img.shape[1]

            zor = tile_size - 2 * radius  # zone of responsibility, inference.py:58
            _check_tile_geometry(tile_size, radius, zor)

            # guarantee full-size windows exist: reflect-pad skinny dims up to tile
            extra_y = max(0, tile_size - height)
            extra_x = max(0, tile_size - width)
            if extra_y or extra_x:
                img = np.pad(img, ((0, extra_y), (0, extra_x), (0, 0)), mode="reflect")
            full_h, full_w = img.shape[0], img.shape[1]
            placements = _zor_placements(height, width, zor, tile_size, radius,
                                         full_h, full_w)
            shrink_u8 = num_classes is not None and num_classes <= 256
            mask_dtype = torch.uint8 if shrink_u8 else torch.int32
            crop = (height - pad_y, width - pad_x)
        for k in PIPELINE:
            PIPELINE[k] = 0
        if devices is not None:
            return _whole_pass(img, _shards(predict_fn, device, devices), placements,
                               tile_size, batch_size, norm_stats, device, (height, width),
                               crop, mask_dtype, device_output)
        return _banded_pass(_host_tensor(img), img.dtype == np.uint16, predict_fn,
                            placements, tile_size, batch_size, norm_stats,
                            _as_device(device), (height, width), crop, mask_dtype,
                            device_output)


def _strip_row(shards, strip: torch.Tensor, xs, tile_size: int,
               batch_size: int, width: int, band_h: int, y_off: int,
               shrink_u8: bool) -> torch.Tensor:
    """One zone row of the streaming path (``_build_strip_row_program`` in
    JAX): cut the row's windows out of the normalized ``(tile, width, C)``
    device strip, run them ``batch_size`` at a time on ``shards`` (from
    :func:`_shards`), and stitch the trimmed zones into a ``(band_h,
    width)`` band. ``y_off = zone_y - window_y``."""
    preds = torch.cat(_forward_tiles(shards, strip, [(0, x_st) for (_, _, x_st) in xs],
                                     tile_size, batch_size))
    band = torch.empty((band_h, width), dtype=torch.uint8 if shrink_u8 else torch.int32,
                       device=strip.device)
    for k, (j, x_end_z, x_st) in enumerate(xs):
        band[:, j:x_end_z] = preds[k, y_off:y_off + band_h, j - x_st:x_end_z - x_st]
    return band


def inference_tiled_streaming(
    reader,
    predict_fn: PredictFn,
    out_path: str,
    tile_size: int = TILE_SIZE,
    radius: int = RADIUS,
    batch_size: int = 8,
    num_classes: Optional[int] = None,
    norm_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    compression_level: int = 6,
    progress: bool = True,
    device="cuda",
    devices=None,
) -> str:
    """Whole-slide inference for images larger than host RAM
    (``tpuseg.infer.tiled.inference_tiled_streaming``): the ZoR/halo grid of
    :func:`inference_tiled`, streamed as a rolling ``(tile, width, C)`` strip
    on the device. Per zone row the host reads only the fresh rows (the
    :class:`~tpuseg_torch.utils.bigtiff.BigTiffReader` ``reader`` decodes
    only the tiles they overlap, on a producer thread one row ahead), ships
    them once in their native dtype, and the device z-scores them, rolls
    the strip, runs the row's windows and stitches the trimmed zone band,
    which an incremental tiled BigTIFF writer with (zor, zor) tiles appends
    to ``out_path``. Peak host memory is a strip of fresh rows plus a band
    or two, whatever the slide's size.

    On the card, transfers overlap compute: the fresh rows go up from
    pinned memory without blocking, and band k comes down into pinned
    memory behind a CUDA event, which is waited on only after row k+1 is
    queued, so the host deflates band k while the card runs row k+1.

    ``norm_stats`` defaults to the reader's single-pass float64 statistics;
    given equal stats the mask equals :func:`inference_tiled`'s. The mask is
    uint8 at <= 256 classes, uint16 at <= 65536, int32 otherwise. On any
    failure the writer is aborted and the reading thread released.

    ``devices`` shards each zone row's windows as :func:`inference_tiled`
    shards its tiles; the strip lives on ``device``.

    Returns ``out_path``.
    """
    from tpuseg_torch.utils.bigtiff import BigTiffTileWriter
    from tpuseg_torch.utils.queues import prefetch_iter

    height, width = reader.height, reader.width
    if height < tile_size or width < tile_size:
        raise ValueError(
            f"streaming path expects a whole-slide image >= {tile_size}px per "
            f"dim, got {height}x{width} — use inference_tiled/_single instead")
    zor = tile_size - 2 * radius
    _check_tile_geometry(tile_size, radius, zor)
    shards = _shards(predict_fn, device, devices)
    device = torch.device(device)
    on_card = device.type == "cuda"

    if norm_stats is None:
        norm_stats = reader.streaming_zscore_stats()
    mean, std = (torch.from_numpy(np.asarray(s, np.float32).reshape(-1)).to(device)
                 for s in norm_stats)

    if num_classes is not None and num_classes <= 256:
        out_dtype: Any = np.uint8
    elif num_classes is not None and num_classes <= 65536:
        out_dtype = np.uint16
    else:
        out_dtype = np.int32
    shrink = num_classes is not None and num_classes <= 256

    # row geometry from a width-1 call and column geometry from a height-1
    # call of the shared grid definition: their outer product is the
    # in-RAM grid, so the two paths cannot disagree
    rows = [(i, y_end_z - i, i - y_st, y_st)  # (zone_y, band_h, y_off, window_y)
            for (i, _, y_end_z, _, y_st, _)
            in _zor_placements(height, 1, zor, tile_size, radius, height, tile_size)]
    xs = [(j, x_end_z, x_st)
          for (_, j, _, x_end_z, _, x_st)
          in _zor_placements(1, width, zor, tile_size, radius, tile_size, width)]
    n_cols = len(xs)
    uint16 = np.dtype(reader.dtype) == np.uint16

    def fresh_rows():
        """Per zone row, the rows its window adds below the last strip (None
        when it adds none), as a host tensor ready to ship: pinned on the
        card, so the upload does not block."""
        prev_end = 0  # exclusive end of the last strip already shipped
        for _, _, _, y_st in rows:
            d = y_st + tile_size - prev_end
            prev_end = y_st + tile_size
            if d == 0:
                yield None
                continue
            t = _host_tensor(reader.read_region(prev_end - d, 0, d, width))
            yield t.pin_memory() if on_card else t

    writer = BigTiffTileWriter(out_path, (height, width), out_dtype,
                               tile=(zor, zor), level=compression_level)
    done = 0

    def start_download(band_dev):
        """Queue band k's copy to the host; returns (host tensor, event)."""
        if not on_card:
            return band_dev, None
        host = torch.empty(band_dev.shape, dtype=band_dev.dtype, pin_memory=True)
        host.copy_(band_dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def write_band(pending):
        nonlocal done
        host, event = pending
        if event is not None:
            event.synchronize()  # band k only: row k+1 keeps running
        band = host.numpy()
        for j, x_end_z, _ in xs:
            writer.put_tile(band[:, j:x_end_z].astype(out_dtype))
        done += n_cols
        if progress:
            print(f"  streamed {done}/{len(rows) * n_cols} zones", flush=True)

    strip = None  # the device-resident, normalized (tile, width, C) window
    pending = None  # band k, on its way to the host while row k+1 runs
    produced = prefetch_iter(fresh_rows(), maxsize=1, name="tpuseg-torch-stream-read")
    try:
        with torch.inference_mode():
            for (_, band_h, y_off, _), new in zip(rows, produced):
                if new is not None:
                    fresh = _zscore(_widen(new.to(device, non_blocking=True), uint16),
                                    mean, std)
                    strip = fresh if strip is None else torch.cat([strip[fresh.shape[0]:], fresh])
                band = _strip_row(shards, strip, xs, tile_size, batch_size, width,
                                  band_h, y_off, shrink)
                if pending is not None:
                    write_band(pending)
                pending = start_download(band)
            if pending is not None:
                write_band(pending)
        writer.close()
    except BaseException:
        writer.abort()
        raise
    finally:
        produced.close()  # stops the reading thread on every exit path
    return out_path


def minimize_dtype(mask: np.ndarray) -> np.ndarray:
    """Shrink the label dtype for saving (inference.py:215-220). Masks with
    negative labels stay int32 — an unsigned cast would wrap them."""
    if mask.size == 0:
        return mask.astype(np.uint8)
    if mask.min() < 0:
        return mask.astype(np.int32)
    mx = mask.max()
    if mx <= 255:
        return mask.astype(np.uint8)
    if mx < 65536:
        return mask.astype(np.uint16)
    return mask.astype(np.int32)
