"""Callback event bus of the port: a copy of the JAX package's utils/callbacks.py.

Its 25 events (the reference's vocabulary); a callback is a plain callable
that receives the object firing the event. Of these the port fires only
the predictor's five (PREDICT_EVENTS) and the exporter's two (EXPORT_EVENTS)."""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

EVENTS = [
    # trainer
    "on_pretrain_routine_start",
    "on_pretrain_routine_end",
    "on_train_start",
    "on_train_epoch_start",
    "on_train_batch_start",
    "optimizer_step",
    "on_before_zero_grad",
    "on_train_batch_end",
    "on_train_epoch_end",
    "on_fit_epoch_end",
    "on_model_save",
    "on_train_end",
    "on_params_update",
    "teardown",
    # validator
    "on_val_start",
    "on_val_batch_start",
    "on_val_batch_end",
    "on_val_end",
    # predictor
    "on_predict_start",
    "on_predict_batch_start",
    "on_predict_batch_end",
    "on_predict_postprocess_end",
    "on_predict_end",
    # exporter
    "on_export_start",
    "on_export_end",
]
# the events the port fires: its predictor's and its exporter's
PREDICT_EVENTS = [e for e in EVENTS if e.startswith("on_predict")]
EXPORT_EVENTS = [e for e in EVENTS if e.startswith("on_export")]


def default_callbacks() -> Dict[str, List[Callable]]:
    return defaultdict(list, {e: [] for e in EVENTS})


def run_callbacks(callbacks: Dict[str, List[Callable]], event: str, obj) -> None:
    for fn in callbacks.get(event, []):
        fn(obj)
