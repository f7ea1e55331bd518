"""The yardstick of the kernels' roofline shares: the chip's peaks
(``peaks.json``) and, one module per kernel, the bytes a launch must move
with each input read once and each output written once."""
from __future__ import annotations

import json
import pathlib


def hbm_bytes_per_s() -> float:
    return float(json.loads((pathlib.Path(__file__).parent / "peaks.json").read_text())
                 ["hbm_bytes_per_s"])
