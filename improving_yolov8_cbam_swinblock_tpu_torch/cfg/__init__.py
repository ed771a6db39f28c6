"""Train configuration of the port: defaults from cfg/default.yaml, overrides on top."""

from __future__ import annotations

import copy
import functools
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import yaml

DEFAULT_CFG = Path(__file__).resolve().parent / "default.yaml"
AUG_KEYS = ("mosaic", "scale", "translate", "fliplr", "hsv_h", "hsv_s", "hsv_v")  # the order of a batch's `aug`


@functools.cache
def _defaults() -> Dict:
    """default.yaml, parsed once a process: predict reads the settings on every call."""
    return yaml.safe_load(DEFAULT_CFG.read_text())


def get_cfg(overrides: Optional[Dict] = None) -> SimpleNamespace:
    """The defaults with `overrides` on top. A key that the defaults do not
    have raises KeyError; a copy_paste_mode other than flip or mixup
    ValueError, as the JAX package's get_cfg does."""
    d = copy.deepcopy(_defaults())
    unknown = sorted(k for k in (overrides or {}) if k not in d)
    if unknown:
        raise KeyError(f"not a train setting of the port: {unknown}")
    d.update(overrides or {})
    if d.get("copy_paste_mode") not in (None, "flip", "mixup"):
        raise ValueError(f"copy_paste_mode={d['copy_paste_mode']!r} must be 'flip' or 'mixup'")
    return SimpleNamespace(**d)
