"""YOLO facade of the PyTorch port: build, load weights, fuse, predict, save.

`YOLO("yolov8s-cbam-swin.yaml")` builds the graph with a seeded random init
on the card; `device="cpu"` is the only way to the CPU. Weights come from
the JAX package's variables (`load_jax_variables`) or from a file that
`save` wrote. For int8 serving, build with fp32 weights
(`param_dtype=torch.float32`), `fuse()`, then quantize the model in place
with `ops.quant.quantize_model(yolo.model, batches)`; `predict` then runs it.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import torch

from ..nn.tasks import DetectionModel
from ..ops.quant import is_quantized
from ..utils.jax_import import state_dict_from_jax
from .predictor import DetectionPredictor


class YOLO:
    def __init__(self, model: str = "yolov8s-cbam-swin.yaml", device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, param_dtype: Optional[torch.dtype] = None):
        self.task = "detect"
        if str(model).endswith(".pt"):
            payload = torch.load(model, map_location="cpu", weights_only=True)
            dtype = getattr(torch, payload["dtype"])
            self.model = DetectionModel(payload["yaml"], dtype=dtype, device=device, seed=seed)
            if payload["fused"]:
                self.model.fuse()
            self.model.load_state_dict(payload["state_dict"], strict=True)
        else:
            self.model = DetectionModel(model, dtype=dtype, device=device, seed=seed, param_dtype=param_dtype)

    @property
    def is_fused(self) -> bool:
        return self.model.is_fused

    def fuse(self) -> "YOLO":
        """Fold every Conv's BatchNorm into its kernel."""
        self.model.fuse()
        return self

    def load_jax_variables(self, variables) -> "YOLO":
        """Load the JAX package's {"params", "batch_stats"} (numpy leaves) into an unfused model."""
        if self.is_fused:
            raise ValueError("load JAX variables before fuse(): the fused model has no BatchNorm to fill")
        self.model.load_state_dict(state_dict_from_jax(variables), strict=True)
        return self

    def predict(self, source, imgsz: int = 640, conf: Optional[float] = None, iou: float = 0.7,
                max_det: int = 300, batch: int = 1):
        """Detections for in-memory BGR uint8 frames; BN-folds a float model
        first (a quantized one keeps its BatchNorms after the int8 convs)."""
        stride = max(self.model.strides)
        imgsz = math.ceil(int(imgsz) / stride) * stride
        if not self.is_fused and not is_quantized(self.model):
            self.fuse()
        predictor = DetectionPredictor(self.model, conf=conf, iou=iou, max_det=max_det, batch=batch)
        return predictor(source, imgsz)

    def save(self, path: str) -> None:
        """Write the graph, dtype and state of a float model. A quantized model
        is refused: save the float model and quantize after loading."""
        if is_quantized(self.model):
            raise ValueError("YOLO.save does not write a quantized model: save the float model, then run "
                             "quantize_model after loading it")
        torch.save({"yaml": self.model.yaml, "fused": self.is_fused, "dtype": str(self.model.dtype).split(".")[-1],
                    "state_dict": self.model.state_dict()}, Path(path))
