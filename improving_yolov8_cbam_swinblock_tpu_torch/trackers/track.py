"""The trackers on the predictor's events: the port's copy of the JAX
package's trackers/track.py. `register_tracker(model)` adds the two
callbacks to a YOLO (or anything with add_callback), so that its predict
carries track ids; YOLO.track fires the same two with its trackers kept
on the YOLO.

A source that is not a stream (frames in memory, files, a video) feeds
one tracker, frame by frame in order, across the frames of a batch and
across batches. A stream source (webcams, stream URLs) keeps one tracker
per stream. Each frame's Results gets the tracks as 7-column boxes
[x1, y1, x2, y2, id, conf, cls] (Results.update) and their ids as
`track_ids`; a frame without an active track keeps its detections and
gets no ids, as in the JAX package. The trackers take the axis-aligned
boxes only: an oriented-box model's `Results.obb` (like a pose model's
keypoints) stays in the detections' order, as the JAX package leaves it.
"""

from __future__ import annotations

import numpy as np

from . import build_tracker


def on_predict_start(predictor, persist: bool = False) -> None:
    """One tracker of predictor.args.tracker for the source, or one per
    stream; with persist, trackers the predictor already has stay."""
    if persist and getattr(predictor, "trackers", None):
        return
    n = int(predictor.bs) if is_stream(predictor) else 1
    predictor.trackers = [build_tracker(predictor.args.tracker or "botsort.yaml") for _ in range(n)]


def on_predict_postprocess_end(predictor, persist: bool = False) -> None:
    """Associate the batch's detections (predictor.results) and give each
    Results its tracks and ids."""
    if not predictor.results:
        return
    if not getattr(predictor, "trackers", None):
        on_predict_start(predictor, persist)
    stream = is_stream(predictor)
    for i, r in enumerate(predictor.results):
        trk = predictor.trackers[min(i, len(predictor.trackers) - 1)] if stream else predictor.trackers[0]
        det = np.asarray(r.boxes.data, np.float32)
        tracks = trk.update(det[:, :4], det[:, 4], det[:, 5])
        if len(tracks):
            r.update(boxes=tracks[:, :7])
            r.track_ids = tracks[:, 4].astype(int)
        else:
            r.track_ids = np.zeros((0,), int)


def is_stream(predictor) -> bool:
    return bool(getattr(getattr(predictor, "source_type", None), "stream", False))


def register_tracker(model, persist: bool = False) -> None:
    """Add the two tracking callbacks to model's predict events."""
    model.add_callback("on_predict_start", lambda p: on_predict_start(p, persist))
    model.add_callback("on_predict_postprocess_end", lambda p: on_predict_postprocess_end(p, persist))
