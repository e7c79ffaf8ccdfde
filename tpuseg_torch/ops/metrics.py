"""Segmentation quality metrics: a confusion matrix with IoU, Dice and
pixel accuracy derived from it.

The port's counterpart of ``tpuseg/ops/metrics.py``. On the device the
JAX package counts with a chunked one-hot matmul (the TPU's matrix unit);
here :func:`confusion_matrix` counts with ``torch.bincount`` over
``truth * K + pred`` in int64, which is exact at any size. Pixels whose
labels fall outside ``[0, K)`` (the 255 void convention, -1) drop out, as
one-hot encoding drops them. Counts come back int32 and ratios float32, as
in JAX.

The corpus evaluation (:func:`evaluate_folder`) is host numpy in float64:
it streams tiled-BigTIFF mask pairs tile by tile, so whole-slide masks
larger than host RAM score without being loaded.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, true: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """[num_classes, num_classes] int32 counts on ``pred``'s device; rows =
    truth, cols = pred."""
    k = num_classes
    p = pred.reshape(-1).to(torch.int64)
    t = true.reshape(-1).to(torch.int64)
    valid = (p >= 0) & (p < k) & (t >= 0) & (t < k)
    # invalid pixels count into one extra bin, cut off below (no boolean
    # indexing, whose output size would need a device sync)
    idx = torch.where(valid, t * k + p, torch.full_like(p, k * k))
    counts = torch.bincount(idx, minlength=k * k + 1)[:k * k]
    return counts.reshape(k, k).to(torch.int32)


def iou_from_confusion(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU; classes absent from both pred and truth get IoU 0."""
    tp = torch.diagonal(cm)
    denom = (cm.sum(dim=0) - tp) + (cm.sum(dim=1) - tp) + tp
    return torch.where(denom > 0, tp.float() / denom.float().clamp_min(1.0),
                       torch.zeros((), device=cm.device))


def segmentation_metrics(logits_or_pred: torch.Tensor, labels: torch.Tensor,
                         num_classes: int) -> Dict[str, torch.Tensor]:
    """logits [N,H,W,C] (argmaxed here) or int predictions [N,H,W]; labels
    one-hot [N,H,W,C] or int [N,H,W]."""
    pred = (torch.argmax(logits_or_pred, dim=-1)
            if logits_or_pred.ndim == 4 else logits_or_pred)
    true = torch.argmax(labels, dim=-1) if labels.ndim == 4 else labels
    cm = confusion_matrix(pred, true, num_classes)
    iou = iou_from_confusion(cm)
    present = (cm.sum(dim=1) + cm.sum(dim=0)) > 0
    zero = torch.zeros((), device=cm.device)
    miou = torch.where(present, iou, zero).sum() / present.sum().clamp_min(1)
    tp = torch.diagonal(cm)
    dice_denom = 2 * tp + (cm.sum(dim=0) - tp) + (cm.sum(dim=1) - tp)
    dice = torch.where(dice_denom > 0,
                       (2 * tp).float() / dice_denom.float().clamp_min(1.0), zero)
    return {
        "confusion": cm,
        "iou": iou,
        "mean_iou": miou,
        "dice": dice,
        "pixel_accuracy": tp.sum().float() / cm.sum().float().clamp_min(1.0),
    }


def _bincount_cm(pred, true, num_classes: int) -> np.ndarray:
    """Exact integer confusion counts on the host (rows = truth, cols =
    pred), the streaming accumulator; the same counts as
    :func:`confusion_matrix`, labels outside ``[0, num_classes)`` dropped."""
    p = np.asarray(pred)
    t = np.asarray(true)
    # trailing singleton channels are benign: imread keeps HW vs HWC1, and
    # both ravel to identically paired pixels
    if p.ndim == 3 and p.shape[-1] == 1:
        p = p[..., 0]
    if t.ndim == 3 and t.shape[-1] == 1:
        t = t[..., 0]
    if p.shape != t.shape:
        # ravelling equal-sized but differently shaped masks (a transposed
        # HxW) would silently pair pixels wrongly
        raise ValueError(f"mask shape mismatch: pred {p.shape} vs true {t.shape}")
    p = p.ravel().astype(np.int64)
    t = t.ravel().astype(np.int64)
    valid = (p >= 0) & (p < num_classes) & (t >= 0) & (t < num_classes)
    if not valid.all():
        p, t = p[valid], t[valid]
    return np.bincount(t * num_classes + p,
                       minlength=num_classes * num_classes
                       ).reshape(num_classes, num_classes)


def _stream_confusion(pred_fp: str, truth_fp: str, num_classes: int) -> np.ndarray:
    """Confusion counts of one mask pair, accumulated tile by tile over the
    prediction's tile grid from two tiled BigTIFFs without loading either
    (accumulated locally, so a failure mid-file leaves the caller's total
    untouched)."""
    from tpuseg_torch.utils.bigtiff import BigTiffReader

    cm = np.zeros((num_classes, num_classes), np.float64)
    with BigTiffReader(pred_fp, tile_cache=1) as pr, \
            BigTiffReader(truth_fp, tile_cache=1) as tr:
        # on another tile grid each pred region spans several truth tiles:
        # cache one truth-tile row so none is inflated twice
        tr.set_cache_size(tr.tiles_across + 2)
        if (pr.height, pr.width) != (tr.height, tr.width):
            # ValueError, not IOError: evaluate_folder falls back to imread
            # on IOError, which would score wrongly paired pixels
            raise ValueError(f"mask shape mismatch: {pred_fp} {pr.shape} vs "
                             f"{truth_fp} {tr.shape}")
        th, tw = pr.tile_height, pr.tile_width
        for ty in range(pr.tiles_down):
            for tx in range(pr.tiles_across):
                y0, x0 = ty * th, tx * tw
                h = min(th, pr.height - y0)
                w = min(tw, pr.width - x0)
                cm += _bincount_cm(pr.read_region(y0, x0, h, w),
                                   tr.read_region(y0, x0, h, w), num_classes)
    return cm


def evaluate_folder(pred_folder: str, truth_folder: str, num_classes: int) -> Dict[str, float]:
    """Host-side corpus evaluation: accumulate the confusion matrix over
    matching mask files in two folders (e.g. inference output vs ground
    truth), then derive mIoU and pixel accuracy. Pairs where both files are
    tiled BigTIFF stream tile by tile; a BigTIFF dialect the reader rejects
    (IOError) falls back to ``imread``."""
    from tpuseg_torch.utils.bigtiff import is_bigtiff
    from tpuseg_torch.utils.imagio import imread

    preds = sorted(os.listdir(pred_folder))
    files = [f for f in preds if os.path.exists(os.path.join(truth_folder, f))]
    if not files:
        raise IOError(f"no matching mask files between {pred_folder} and {truth_folder}")
    # a partial prediction set must not silently score as the corpus mIoU
    unmatched_pred = len(preds) - len(files)
    matched = set(files)
    unmatched_truth = sum(1 for f in os.listdir(truth_folder) if f not in matched)
    if unmatched_pred or unmatched_truth:
        print(f"WARNING: scoring {len(files)} matched pairs; "
              f"{unmatched_pred} prediction file(s) and {unmatched_truth} "
              f"truth file(s) have no counterpart and are NOT scored")
    cm_total = np.zeros((num_classes, num_classes), np.float64)
    for fn in files:
        pred_fp = os.path.join(pred_folder, fn)
        truth_fp = os.path.join(truth_folder, fn)
        if is_bigtiff(pred_fp) and is_bigtiff(truth_fp):
            try:
                cm_total += _stream_confusion(pred_fp, truth_fp, num_classes)
                continue
            except IOError:
                pass  # foreign BigTIFF dialect: imread's backends read it
        pred = np.asarray(imread(pred_fp)).astype(np.int32)
        true = np.asarray(imread(truth_fp)).astype(np.int32)
        cm_total += _bincount_cm(pred, true, num_classes)
    # float64: exact counts above 2^24 pixels
    tp = np.diag(cm_total)
    denom = cm_total.sum(axis=1) + cm_total.sum(axis=0) - tp
    iou = np.where(denom > 0, tp / np.maximum(denom, 1.0), 0.0)
    present = (cm_total.sum(axis=1) + cm_total.sum(axis=0)) > 0
    miou = float(iou[present].mean()) if present.any() else 0.0
    return {
        "mean_iou": miou,
        "per_class_iou": [float(v) for v in iou],
        "pixel_accuracy": float(np.trace(cm_total) / max(cm_total.sum(), 1.0)),
        "num_images": len(files),
        "num_unmatched_pred": unmatched_pred,
        "num_unmatched_truth": unmatched_truth,
    }
