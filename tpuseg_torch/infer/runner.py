"""Folder-level inference runner (reference ``inference.py::inference``,
inference.py:176-227), counterpart of ``tpuseg/infer/runner.py``: load the
checkpoint, read images ahead of the device work with their whole-image
z-score statistics (the normalization itself runs on the device), batch
sub-tile images and halo-tile large ones, then dtype-minimize and save;
with ``streaming``, stream tiled-BigTIFF slides through the device as a
rolling strip and write their masks incrementally.

Runs on ``cfg.device`` — the card by default; asking for it without one
raises instead of carrying on on the CPU. With ``data_parallel`` each tile
group shards over the GPUs this process owns, one model replica each
(``infer/tiled.py``): every visible GPU when the process is its node's
only one, ``cuda:LOCAL_RANK`` under a multi-process torchrun, and an
explicit ``cuda:N`` always. Several processes (``cli.inference --multihost
1``) stripe the sorted folder: process k of n segments images k, k+n, ...,
and int8 calibration samples the whole folder, so every process derives
the same scales.
"""

from __future__ import annotations

import copy
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from tpuseg_torch.data.preprocess import zscore_stats
from tpuseg_torch.infer.erf import estimate_radius
from tpuseg_torch.parallel import distributed
from tpuseg_torch.infer.tiled import (
    TILE_SIZE,
    inference_single_batch,
    inference_tiled,
    make_predict_fn,
    minimize_dtype,
)
from tpuseg_torch.utils import checkpoint
from tpuseg_torch.utils.imagio import imread, imwrite
from tpuseg_torch.utils.queues import prefetch_iter

QUANTIZE_MODES = ("none", "int8", "int8_blocked", "int8_auto")


@dataclass
class InferenceConfig:
    checkpoint_filepath: str
    image_folder: str
    output_folder: str
    number_classes: int
    number_channels: int
    image_format: str = "tif"
    tile_size: int = TILE_SIZE
    batch_size: int = 8  # tiles per forward
    radius: Optional[int] = None  # None -> ERF probe (reference behavior)
    dtype: str = "bfloat16"
    base_features: int = 64
    # "cuda" (default), "cuda:N" or "cpu"; "cuda" without a card raises
    device: str = "cuda"
    # shard each tile group over the GPUs this process owns (module
    # docstring); a no-op with one
    data_parallel: bool = True
    # stream tiled-BigTIFF inputs as a rolling strip of rows (images larger
    # than host RAM); masks are written incrementally as tiled BigTIFF
    streaming: bool = False
    # overlap the next image's disk read + stats with device compute
    read_ahead: bool = True
    # choose the tile size per image to minimize computed pixels
    # (infer.tiled.choose_tile_size); tile_size keeps gating the dispatch
    auto_tile: bool = False
    # "int8" / "int8_blocked" / "int8_auto": the post-training-quantized
    # engines of infer/quant.py (see tpuseg.infer.runner for the modes);
    # int8_auto serves halo-tiled images blocked and small batches dense
    quantize: str = "none"
    calibration_images: int = 4
    # |activation| percentile defining the int8 clip range (100 = exact max)
    calibration_percentile: float = 99.9
    # seeds the ERF probe's noise image (None: fresh entropy, as the reference)
    seed: Optional[int] = None
    # persisted int8 calibration: load (skipping calibration) / write
    calibration_in: Optional[str] = None
    calibration_out: Optional[str] = None
    # this process's stripe of the folder (None: ask the process group)
    process_index: Optional[int] = None
    process_count: Optional[int] = None


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU, and never the CPU in place of a missing card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} was asked for but torch.cuda.is_available() is "
            "false; pass --device cpu to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {name!r}")
    return device


def _serving_devices(cfg: InferenceConfig):
    """``(device, devices)``: the device the image and the stitching live
    on, and the GPUs each tile group shards over (None: ``device`` alone).
    ``cuda`` without an index is every visible GPU for the node's only
    process, and ``cuda:LOCAL_RANK`` under a multi-process torchrun."""
    device = resolve_device(cfg.device)
    if device.type != "cuda" or device.index is not None:
        return device, None
    if distributed.local_world_size() > 1:
        return torch.device("cuda", distributed.local_rank()), None
    n = torch.cuda.device_count()
    if not cfg.data_parallel or n == 1:
        return device, None
    devices = [torch.device("cuda", i) for i in range(n)]
    return devices[0], devices


def _fp_replicas(model, devices):
    """The fp predict function, or one per entry of ``devices``: the model
    for the first, a copy on each other entry's device."""
    if devices is None:
        return make_predict_fn(model)
    return [make_predict_fn(model if i == 0 else copy.deepcopy(model).to(d))
            for i, d in enumerate(devices)]


def load_model(cfg: InferenceConfig, device: torch.device):
    """Rebuild the checkpoint's U-Net on ``device`` in ``cfg.dtype`` and
    check it against the configured classes/channels/width
    (model.py:81-83)."""
    model = checkpoint.load_model(cfg.checkpoint_filepath, dtype=cfg.dtype, device=device)
    if model.kind != "unet":
        raise ValueError(f"{cfg.checkpoint_filepath} holds a {model.kind}: serving "
                         "takes U-Net checkpoints only")
    got = (model.num_classes, model.num_channels, model.base_features)
    want = (cfg.number_classes, cfg.number_channels, cfg.base_features)
    if got != want:
        raise ValueError(
            f"{cfg.checkpoint_filepath} holds a U-Net with (classes, channels, "
            f"base_features) = {got}, but the run asks for {want}")
    return model


def _erf_rng(cfg: InferenceConfig) -> Optional[np.random.Generator]:
    """Noise source for the ERF probe: seeded when ``cfg.seed`` is set so
    tile geometry is reproducible across runs."""
    return None if cfg.seed is None else np.random.default_rng(cfg.seed)


def _inference_streaming(cfg: InferenceConfig, model, predict_fn,
                         img_filepath_list: List[str], device: torch.device,
                         calib_cache: Optional[dict] = None,
                         devices=None) -> List[str]:
    """Whole-slide streaming mode: every input must be a tiled BigTIFF; its
    rows stream through the device and the mask is written incrementally,
    so images larger than host RAM segment end to end."""
    from tpuseg_torch.infer.tiled import inference_tiled_streaming
    from tpuseg_torch.utils.bigtiff import BigTiffReader

    radius = cfg.radius
    written = []
    print("Starting streaming inference of file list")
    for i, img_filepath in enumerate(img_filepath_list):
        _, slide_name = os.path.split(img_filepath)
        print(f"{i}/{len(img_filepath_list)} : {slide_name}")
        out_path = os.path.join(cfg.output_folder, slide_name)
        if os.path.realpath(out_path) == os.path.realpath(img_filepath):
            # the writer would truncate the slide the reader is still
            # reading regions from
            raise ValueError(
                f"streaming inference cannot write over its input: {img_filepath}")
        with BigTiffReader(img_filepath) as reader:
            print(f"  img.shape={reader.shape}")
            _check_channels(reader.shape, cfg.number_channels, img_filepath)
            if radius is None:
                radius = estimate_radius(model, cfg.number_channels, rng=_erf_rng(cfg))
                print(f'Estimated radius based on ERF : "{radius}"')
            tile = cfg.tile_size
            if cfg.auto_tile:
                tile = _auto_tile(cfg, reader.height, reader.width, radius,
                                  max_dim=min(reader.height, reader.width))
            # int8 calibration already scanned this slide for its stats
            cached = (calib_cache or {}).pop(img_filepath, None)
            inference_tiled_streaming(
                reader, predict_fn, out_path, tile, radius, cfg.batch_size,
                num_classes=cfg.number_classes,
                norm_stats=None if cached is None else cached[1], device=device,
                devices=devices)
        written.append(out_path)
    return written


def _auto_tile(cfg: InferenceConfig, height: int, width: int, radius: int,
               max_dim: Optional[int] = None) -> int:
    """The per-image tile choice for ``--auto_tile`` (slot-cost-optimal,
    capped by the batch and by ``max_dim``, since streaming needs slide >=
    tile), degrading to the configured tile when no halo-valid size exists
    and that tile is itself valid."""
    from tpuseg_torch.infer.tiled import choose_tile_size, max_auto_tile

    cap = max_auto_tile(cfg.batch_size)
    if max_dim is not None:
        cap = min(cap, (max_dim // 16) * 16)
    try:
        tile = choose_tile_size(height, width, radius, min_tile=min(512, cap),
                                max_tile=cap, chunk=cfg.batch_size)
        print(f"  auto tile size: {tile}")
        return tile
    except ValueError:
        if (cfg.tile_size - 2 * radius >= radius
                and cfg.tile_size % 16 == 0 and radius % 16 == 0):
            return cfg.tile_size
        raise


def _calibration_sample(paths: List[str], k: int) -> List[str]:
    """Deterministic evenly-spaced sample of the sorted folder for int8
    calibration: indices ``floor(i * n/k)`` for ``i < k``."""
    k = max(1, min(k, len(paths)))
    return [paths[(i * len(paths)) // k] for i in range(k)]


_CALIB_MAX_DIM = 512  # one canonical calibration crop shape
# decoded calibration inputs this large in total stay cached for reuse by
# the inference pass; beyond the budget only the stats are kept
_CALIB_CACHE_BYTES = 1 << 30


def _quantized_predict_fn(cfg: InferenceConfig, model, img_filepath_list: List[str],
                          device: torch.device, replicas: Optional[int] = None):
    """Build the int8 serving predict_fns (infer/quant.py), calibrating on
    central crops of an evenly-spaced sample of the folder, normalized as
    inference normalizes them, on ``device``.

    Returns ``(tiled_fn, small_fn, calib_cache)``: the predict_fn for the
    halo-tiled dispatch and the one for batched small images (the same
    object except under ``int8_auto``), and a map from each calibration
    path to ``(decoded image or None, (mean, std))`` that the inference pass
    reuses (for a streamed slide only its stats: the streaming engine reads
    the slide itself). ``cfg.calibration_in`` loads persisted scales
    instead. With ``replicas``, each of the two is a list of that many
    predict functions from the one calibration, one per shard: each keeps
    its folded int8 weights, scales and head constants on the device of the
    batches it is given."""
    if cfg.quantize not in QUANTIZE_MODES[1:]:
        raise ValueError(f'unknown quantize mode "{cfg.quantize}" '
                         '(use "none", "int8", "int8_blocked" or "int8_auto")')
    from tpuseg_torch.infer import quant
    from tpuseg_torch.utils.bigtiff import BigTiffReader

    def _fns(folded, ranges):
        def build(blocked):
            if replicas is None:
                return quant.make_quantized_predict_fn(
                    folded, ranges, deconv_impl=model.deconv_impl, blocked_edges=blocked)
            return [quant.make_quantized_predict_fn(
                folded, ranges, deconv_impl=model.deconv_impl, blocked_edges=blocked)
                for _ in range(replicas)]

        if cfg.quantize == "int8_auto":
            return build(True), build(False)
        fn = build(cfg.quantize == "int8_blocked")
        return fn, fn

    if cfg.calibration_in:
        ranges = quant.load_act_ranges(
            cfg.calibration_in, expect_percentile=cfg.calibration_percentile)
        print(f"quantize={cfg.quantize}: loaded calibration scales from "
              f"{cfg.calibration_in} (skipping calibration)")
        tiled_fn, small_fn = _fns(quant.fold_variables(model), ranges)
        return tiled_fn, small_fn, {}

    raw = []  # (central crop <= _CALIB_MAX_DIM, whole-image mean, std)
    calib_cache: dict = {}
    cached_bytes = 0
    for p in _calibration_sample(img_filepath_list, cfg.calibration_images):
        if cfg.streaming:
            with BigTiffReader(p) as reader:
                _check_channels(reader.shape, cfg.number_channels, p)
                # the stats streaming inference normalizes with: a window's
                # own stats can misfit (a blank center tripping the std<=1
                # guard while the slide's std does not)
                mean, std = reader.streaming_zscore_stats()
                h = min(reader.height, _CALIB_MAX_DIM)
                w = min(reader.width, _CALIB_MAX_DIM)
                crop = reader.read_region((reader.height - h) // 2,
                                          (reader.width - w) // 2, h, w)
            calib_cache[p] = (None, (mean, std))
        else:
            img = imread(p)
            _check_channels(img.shape, cfg.number_channels, p)
            mean, std = zscore_stats(img)  # whole-image stats, as inference uses
            h = min(img.shape[0], _CALIB_MAX_DIM)
            w = min(img.shape[1], _CALIB_MAX_DIM)
            y0, x0 = (img.shape[0] - h) // 2, (img.shape[1] - w) // 2
            crop = np.array(img[y0:y0 + h, x0:x0 + w], np.float32)
            if cached_bytes + img.nbytes <= _CALIB_CACHE_BYTES:
                calib_cache[p] = (img, (mean, std))
                cached_bytes += img.nbytes
            else:
                calib_cache[p] = (None, (mean, std))
                del img
        crop = np.asarray(crop, np.float32)
        if crop.ndim == 2:
            crop = crop[..., None]
        raw.append((crop, mean, std))
    # floor-to-x16 of the smallest crop dims: every crop admits an exact
    # central re-crop of this shape
    ch = max(16, min(c.shape[0] for c, _, _ in raw) // 16 * 16)
    cw = max(16, min(c.shape[1] for c, _, _ in raw) // 16 * 16)
    calib = []
    for crop, mean, std in raw:
        y0 = max(0, (crop.shape[0] - ch) // 2)
        x0 = max(0, (crop.shape[1] - cw) // 2)
        crop = crop[y0:y0 + ch, x0:x0 + cw]
        safe_std = np.where(std <= 1.0, 1.0, std)  # imagereader.py:44-49 guard
        calib.append((crop - mean) / safe_std)
    print(f"quantize=int8: calibrating on {len(calib)} image(s) at {ch}x{cw}")
    folded = quant.fold_variables(model)
    ranges = quant.calibrate(folded, calib, deconv_impl=model.deconv_impl,
                             percentile=cfg.calibration_percentile, device=device)
    if cfg.calibration_out:
        quant.save_act_ranges(cfg.calibration_out, ranges,
                              percentile=cfg.calibration_percentile)
        print(f"wrote calibration scales to {cfg.calibration_out}")
    tiled_fn, small_fn = _fns(folded, ranges)
    return tiled_fn, small_fn, calib_cache


def _check_channels(img_shape, number_channels: int, path: str) -> None:
    """Fail fast — before any device work — when an input image's channel
    count doesn't match the model."""
    if len(img_shape) not in (2, 3):
        raise ValueError(
            f"Invalid number of dimensions for input image "
            f"(expected HW or HWC, got shape {tuple(img_shape)}): {path}")
    channels = img_shape[2] if len(img_shape) == 3 else 1
    if channels != number_channels:
        raise ValueError(
            f"Input image {path} has {channels} channel(s) but the model "
            f"expects number_channels={number_channels}. Input images should "
            f"be either HW or HWC dimension ordering")


def _read_ahead(paths: List[str], depth: int = 1, enabled: bool = True,
                cache: Optional[dict] = None):
    """Yield ``(path, image, zscore_stats)`` with the disk read + statistics
    of the *next* image overlapped with the caller's device work; ``cache``
    holds what int8 calibration already decoded (popped on use)."""
    cache = cache or {}

    def _load(p):
        img, stats = cache.pop(p, (None, None))
        if img is None:
            img = imread(p)
        if stats is None:
            stats = zscore_stats(img)
        return p, img, stats

    if not enabled:
        for p in paths:
            yield _load(p)
        return
    yield from prefetch_iter((_load(p) for p in paths), maxsize=depth,
                             name="tpuseg-torch-infer-read")


def _check_supported(cfg: InferenceConfig) -> None:
    if cfg.quantize not in QUANTIZE_MODES:
        raise ValueError(f'unknown quantize mode "{cfg.quantize}" '
                         '(use "none", "int8", "int8_blocked" or "int8_auto")')
    if cfg.quantize == "none" and (cfg.calibration_in or cfg.calibration_out):
        raise ValueError("calibration_in/calibration_out require "
                         'quantize="int8", "int8_blocked" or "int8_auto"')
    if cfg.calibration_in and cfg.calibration_out:
        raise ValueError("calibration_in skips calibration, so there are no "
                         "fresh scales for calibration_out — pass one or the "
                         "other")


def inference(cfg: InferenceConfig) -> List[str]:
    """Segment every ``*.image_format`` file in ``image_folder``; returns
    the list of written mask paths."""
    _check_supported(cfg)
    device, devices = _serving_devices(cfg)

    print("Arguments:")
    print(f"checkpoint_filepath = {cfg.checkpoint_filepath}")
    print(f"image_folder = {cfg.image_folder}")
    print(f"output_folder = {cfg.output_folder}")
    print(f"image_format = {cfg.image_format}")
    print(f"number_classes = {cfg.number_classes}")
    print(f"number_channels = {cfg.number_channels}")
    print(f"device = {device}")

    os.makedirs(cfg.output_folder, exist_ok=True)
    fmt = cfg.image_format.lstrip(".")
    img_filepath_list = [
        os.path.join(cfg.image_folder, fn)
        for fn in sorted(os.listdir(cfg.image_folder)) if fn.endswith(f".{fmt}")
    ]
    # int8 calibration samples the GLOBAL sorted folder, fixed before the
    # striping, so every process derives the same scales and masks
    global_filepath_list = img_filepath_list
    n = cfg.process_count if cfg.process_count is not None else distributed.process_count()
    if n > 1:
        # images are independent: each process segments its stride of the
        # sorted folder and writes its masks under their own names
        me = cfg.process_index if cfg.process_index is not None else distributed.process_index()
        print(f"process {me}/{n}: segmenting {len(img_filepath_list[me::n])} of "
              f"{len(img_filepath_list)} images")
        img_filepath_list = img_filepath_list[me::n]
    if devices is not None:
        print(f"Sharding tile groups over {len(devices)} local GPUs")

    model = load_model(cfg, device)
    calib_cache: dict = {}
    if cfg.quantize == "none" or not img_filepath_list:
        if cfg.quantize != "none":
            skipped = (f"; requested --calibration_out {cfg.calibration_out} "
                       "was NOT written by this process" if cfg.calibration_out else "")
            why = (f"this process's stripe of {len(global_filepath_list)} images is empty"
                   if global_filepath_list else
                   f"no images matched --image_format {cfg.image_format} in "
                   f"{cfg.image_folder}")
            print(f"WARNING: {why} — int8 calibration skipped{skipped}")
        predict_fn = small_predict_fn = _fp_replicas(model, devices)
    else:
        predict_fn, small_predict_fn, calib_cache = _quantized_predict_fn(
            cfg, model, global_filepath_list, device,
            None if devices is None else len(devices))
        # the reuse cache only helps for this process's images
        mine = set(img_filepath_list)
        calib_cache = {p: v for p, v in calib_cache.items() if p in mine}

    if cfg.streaming:
        return _inference_streaming(cfg, model, predict_fn, img_filepath_list, device,
                                    calib_cache, devices)

    radius = cfg.radius
    written = []
    small_buf = []  # same-shape sub-tile images batched through one forward

    def _save(mask, img_filepath):
        _, slide_name = os.path.split(img_filepath)
        out_path = os.path.join(cfg.output_folder, slide_name)
        imwrite(out_path, minimize_dtype(mask))
        written.append(out_path)

    def _flush_small():
        if not small_buf:
            return
        masks = inference_single_batch(
            [im for _, im, _ in small_buf], small_predict_fn, cfg.batch_size,
            stats=[st for _, _, st in small_buf], device=device, devices=devices)
        for (p, _, _), mask in zip(small_buf, masks):
            _save(mask, p)
        small_buf.clear()

    print("Starting inference of file list")
    for i, (img_filepath, img, stats) in enumerate(
            _read_ahead(img_filepath_list, enabled=cfg.read_ahead,
                        cache=calib_cache)):
        _, slide_name = os.path.split(img_filepath)
        print(f"{i}/{len(img_filepath_list)} : {slide_name}")
        print(f"  img.shape={img.shape}")
        _check_channels(img.shape, cfg.number_channels, img_filepath)

        if img.shape[0] > cfg.tile_size or img.shape[1] > cfg.tile_size:
            _flush_small()
            if radius is None:
                radius = estimate_radius(model, cfg.number_channels, rng=_erf_rng(cfg))
                print(f'Estimated radius based on ERF : "{radius}"')
            tile = cfg.tile_size
            if cfg.auto_tile:
                tile = _auto_tile(cfg, img.shape[0], img.shape[1], radius)
            mask = inference_tiled(img, predict_fn, tile, radius, cfg.batch_size,
                                   num_classes=cfg.number_classes,
                                   norm_stats=stats, device=device, devices=devices)
            _save(mask, img_filepath)
        else:
            # batch sub-tile images; flush preserves the folder's file order
            if small_buf and small_buf[-1][1].shape != img.shape:
                _flush_small()
            small_buf.append((img_filepath, img, stats))
            if len(small_buf) == cfg.batch_size * len(devices or [device]):
                _flush_small()
    _flush_small()
    return written
