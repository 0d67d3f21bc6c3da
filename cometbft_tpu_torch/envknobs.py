"""Environment knobs, read as cometbft_tpu/utils/envknobs reads them, so
the port routes by the JAX package's variables with its defaults."""

from __future__ import annotations

import os


def get_int(name: str, default: int) -> int:
    """An unset, empty or malformed value gives the default."""
    try:
        return int(os.environ.get(name, ""))
    except ValueError:
        return default


def get_bool(name: str, default: bool) -> bool:
    """1 / true / yes / on and 0 / false / no / off (any case); anything
    else, unset or empty, gives the default."""
    v = os.environ.get(name, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default
