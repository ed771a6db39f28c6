"""YOLO facade of the PyTorch port: build, load weights, fuse, predict, train, val, save.

`YOLO("yolov8s-cbam-swin.yaml")` builds the graph with a seeded random init
on the card; `device="cpu"` is the only way to the CPU. Weights come from
the JAX package's variables (`load_jax_variables`) or from a file that
`save` wrote. For int8 serving, build with fp32 weights
(`param_dtype=torch.float32`), `fuse()`, then quantize the model in place
with `ops.quant.quantize_model(yolo.model, batches)`; `predict` and `val`
then run it. `train(data=...)` trains on the model's device (a model loaded
from a file warm-starts the trainer) and adopts best.pt's EMA weights;
`val(data=...)` returns ValMetrics.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional

import torch

from ..cfg import get_cfg
from ..data.build import build_dataloader, build_yolo_dataset
from ..data.dataset import check_det_dataset
from ..nn.tasks import DetectionModel
from ..ops.quant import is_quantized
from ..utils.jax_import import state_dict_from_jax
from ..utils.metrics import ValMetrics
from .predictor import DetectionPredictor
from .trainer import DetectionTrainer, check_supported
from .validator import DetectionValidator


class YOLO:
    def __init__(self, model: str = "yolov8s-cbam-swin.yaml", device=None, dtype: torch.dtype = torch.float32,
                 seed: int = 0, param_dtype: Optional[torch.dtype] = None):
        self.task = "detect"
        self.ckpt_path = None
        self.trainer = None
        self.validator = None
        if str(model).endswith(".pt"):
            payload = torch.load(model, map_location="cpu", weights_only=True)
            dtype = getattr(torch, payload["dtype"])
            param_dtype = getattr(torch, payload["param_dtype"]) if "param_dtype" in payload else None
            self.model = DetectionModel(payload["yaml"], dtype=dtype, device=device, seed=seed,
                                        param_dtype=param_dtype)
            if payload["fused"]:
                self.model.fuse()
            self.model.load_state_dict(payload["state_dict"], strict=True)
            if "names" in payload:
                self.model.names = dict(payload["names"])
            self.ckpt_path = str(model)
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

    def train(self, data: str, **kwargs) -> Dict[str, float]:
        """Train on `data` (a data YAML or dict) with the trainer's settings in
        kwargs, on this model's device unless `device` is given. A model
        loaded from a file hands its weights to the trainer's warm start
        (same-shape overlay). Afterwards this YOLO holds best.pt's EMA
        weights, or the final EMA when no best.pt was written."""
        overrides = {**kwargs, "data": data, "model": self.model.yaml}
        trainer = DetectionTrainer(overrides=overrides, device=kwargs.get("device") or self.model.device)
        if self.ckpt_path is not None:
            trainer.pretrained_state = self.model.state_dict()
        self.trainer = trainer
        metrics = trainer.train()
        best = trainer.wdir / "best.pt"
        if best.exists():
            self.model = YOLO(str(best), device=trainer.device).model
        else:
            self.model = trainer.eval_model()
        return metrics

    def val(self, data: Optional[str] = None, **kwargs) -> ValMetrics:
        """Detection metrics of this model (float or quantized, as it is) on
        the `split` (default val) of `data`, with `batch`, `imgsz`, `rect`,
        `max_det`, `workers` and `verbose` from kwargs."""
        args = get_cfg(kwargs)
        check_supported(args)
        stride = max(self.model.strides)
        args.imgsz = math.ceil(int(args.imgsz) / stride) * stride
        info = check_det_dataset(data or args.data)
        split = args.split if info.get(args.split) else "val"
        ds = build_yolo_dataset(args, info[split], info, mode="val")
        rect_shape = ds.rect_shape(stride=int(stride)) if args.rect else None
        loader = build_dataloader(ds, int(args.batch), workers=args.workers, train=False, rect_shape=rect_shape)
        self.validator = DetectionValidator(self.model, loader, args)
        out = ValMetrics(self.validator())
        for k in ("precision", "recall", "mAP50", "mAP50-95"):
            out[f"metrics/{k}(B)"] = out[k]
        out.box = self.validator.metrics.box
        return out

    def save(self, path: str) -> None:
        """Write the graph, the compute dtype, the dtype of the Conv and Swin
        weight matrices (param_dtype, so fp32 masters reload as fp32) and the
        state of a float model. A quantized model is refused: save the float
        model and quantize after loading."""
        if is_quantized(self.model):
            raise ValueError("YOLO.save does not write a quantized model: save the float model, then run "
                             "quantize_model after loading it")
        m = self.model
        torch.save({"yaml": m.yaml, "fused": self.is_fused, "dtype": str(m.dtype).removeprefix("torch."),
                    "param_dtype": str(m.param_dtype).removeprefix("torch."), "state_dict": m.state_dict()},
                   Path(path))
