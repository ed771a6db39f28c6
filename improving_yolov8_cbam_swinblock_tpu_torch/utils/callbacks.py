"""Callback event bus of the port: a copy of the JAX package's utils/callbacks.py.

Its 25 events (the reference's vocabulary); a callback is a plain callable
that receives the object firing the event. The port fires the events the
JAX package fires, at the same points: the trainer's (pretrain routine start
and end, train start, train epoch start, train batch end, model save, fit
epoch end, train end, val start and end), the validator's val batch start
and end, the predictor's five and the exporter's two. Neither package fires
the six of NEVER_FIRED."""

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
NEVER_FIRED = ["on_train_batch_start", "optimizer_step", "on_before_zero_grad", "on_train_epoch_end",
               "on_params_update", "teardown"]


def default_callbacks() -> Dict[str, List[Callable]]:
    return defaultdict(list, {e: [] for e in EVENTS})


def run_callbacks(callbacks: Dict[str, List[Callable]], event: str, obj) -> None:
    for fn in callbacks.get(event, []):
        fn(obj)
