"""Multi-object trackers of the port: its copy of the JAX package's
trackers/ (ByteTrack and BoT-SORT, numpy host code) and their link to the
predictor's events (track.py), which YOLO.track uses."""

from pathlib import Path

import yaml

from .bot_sort import BOTSORT
from .byte_tracker import BYTETracker

TRACKER_MAP = {"bytetrack": BYTETracker, "botsort": BOTSORT}
TRACKER_CFG_DIR = Path(__file__).resolve().parent.parent / "cfg" / "trackers"


def build_tracker(tracker="bytetrack", frame_rate: int = 30):
    """A tracker from its YAML: a packaged name ("bytetrack", "botsort.yaml")
    resolves against the port's cfg/trackers/, a path to a user YAML with
    the same keys. A tracker_type other than bytetrack or botsort raises
    ValueError."""
    name = str(tracker)
    p = Path(name if name.endswith((".yaml", ".yml")) else name + ".yaml")
    if not p.exists():
        p = TRACKER_CFG_DIR / p.name
    if not p.exists():
        raise FileNotFoundError(f"tracker config not found: {tracker}")
    cfg = yaml.safe_load(p.read_text()) or {}
    ttype = cfg.get("tracker_type", "bytetrack")
    if ttype not in TRACKER_MAP:
        raise ValueError(f"Only 'bytetrack' and 'botsort' are supported, got tracker_type={ttype!r}")
    kw = {k: cfg[k] for k in (
        "track_high_thresh", "track_low_thresh", "new_track_thresh", "track_buffer", "match_thresh"
    ) if k in cfg}
    if "fuse_score" in cfg:
        kw["fuse_score_flag"] = bool(cfg["fuse_score"])
    if ttype == "botsort":
        for k in ("gmc_method", "proximity_thresh", "appearance_thresh", "with_reid"):
            if k in cfg:
                kw[k] = cfg[k]
    return TRACKER_MAP[ttype](frame_rate=frame_rate, **kw)
