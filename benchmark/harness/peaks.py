"""The published peaks of the card (``peaks.json``)."""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    _PEAKS = json.load(_f)

OPS_PER_S = {k: float(v) for k, v in _PEAKS["ops_per_s"].items()}
HBM_BYTES_PER_S = float(_PEAKS["hbm_bytes_per_s"])
