"""Raw float32 dumps of the predict outputs."""

from __future__ import annotations

import numpy as np


def write_raw_float32(fname: str, x) -> None:
    """Header-less float32 dump (predict outputs left/right/disp.bin,
    main.lua:1045,1103; loadable per samples/load_bin.py)."""
    np.asarray(x, dtype=np.float32).tofile(fname)
