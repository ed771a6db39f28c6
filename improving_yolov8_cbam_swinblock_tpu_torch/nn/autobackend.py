"""Backend: one inference facade over the port's artifacts and checkpoints.

Counterpart of the JAX package's nn/autobackend.py. It serves:
  - a `.pt2` program that engine/exporter.py wrote, through
    torch.export.load(...).module(); importing this module imports the
    port's operators (ops/swin.py, ops/swin_int8.py) first, which a program
    holding them needs before it is loaded;
  - a `.ckpt` or `.msgpack` of the JAX package (its EMA weights, fused or
    not) and the port's `.pt`, through the YOLO facade's loaders;
  - a live DetectionModel.

    be = Backend("model_640_half.pt2")       # device=None: the card
    out = be(frames_uint8_nhwc)              # numpy float32 (B, 4+nc, A)
    be.names, be.stride, be.imgsz, be.task   # from the sidecar <file>.yaml

Input: (B, H, W, 3) uint8 NHWC frames, numpy or a tensor. Output: numpy
float32, the Detect layout, or (B, max_det, 6) for a program exported with
nms and for a YOLOv10 model or program (`end2end`); for a segmentation
model or program (`task` "segment") two arrays, the (B, 4+nc+nm, A)
prediction and the (B, nm, H/4, W/4) prototypes; for a classify model or
program (`task` "classify") the (B, nc) softmax. A checkpoint or model
runs as it is, unfused, in the dtype it was built with (fp32 for a JAX
checkpoint), as the JAX Backend runs its checkpoints. A program runs on the
device it was exported on.

ProgramModel puts a program behind the interface the predictor drives, so
that `YOLO("model.pt2")` predicts and tracks with it: boxes, and masks from
a segmentation program's prototypes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import yaml

from ..engine.exporter import ExportForward
from ..ops import swin, swin_int8  # noqa: F401  (registers the operators an exported program holds)
from ..utils.device import select_device

CHECKPOINT_SUFFIXES = (".ckpt", ".msgpack", ".pt")


def _indexed(dev: torch.device) -> torch.device:
    """`cuda` as the card it means (`cuda:0`), as tensors name their device."""
    return torch.device("cuda", torch.cuda.current_device()) if dev.type == "cuda" and dev.index is None else dev


class Backend:
    def __init__(self, weights: Any, imgsz: Optional[int] = None, device=None):
        self.format = None
        self.metadata: Dict = {}
        if isinstance(weights, nn.Module):
            self._init_live(weights, imgsz, device)
            return
        p = Path(str(weights))
        self.device = _indexed(select_device(device))
        meta = Path(f"{p}.yaml")
        if meta.exists():
            self.metadata = yaml.safe_load(meta.read_text()) or {}
        if p.suffix == ".pt2":
            self._init_pt2(p)
        elif p.suffix in CHECKPOINT_SUFFIXES:
            self._init_checkpoint(p)
        else:
            raise ValueError(f"cannot infer the backend of {weights!r} (expected .pt2 / .ckpt / .msgpack / .pt / a "
                             "live model)")
        if imgsz and "imgsz" not in self.metadata:
            self.metadata["imgsz"] = [int(imgsz)] * 2

    # -- metadata (the reference AutoBackend's attributes) ----------------
    @property
    def names(self) -> Dict[int, str]:
        return {int(k): str(v) for k, v in self.metadata.get("names", {}).items()}

    @property
    def stride(self) -> int:
        return int(self.metadata.get("stride", 32))

    @property
    def imgsz(self):
        return self.metadata.get("imgsz")

    @property
    def task(self) -> str:
        return self.metadata.get("task", "detect")

    @property
    def nc(self) -> int:
        return int(self.metadata.get("nc", max(len(self.names), 1)))

    @property
    def end2end(self) -> bool:
        """True where the output is (B, max_det, 6) detections: a program
        exported with nms=True, and a YOLOv10 model or program (its sidecar's
        `end2end`; the JAX Backend reads `nms` only)."""
        return bool(self.metadata.get("nms", False) or self.metadata.get("end2end", False))

    # -- per-format initializers ------------------------------------------
    def _adopt(self, model: nn.Module) -> None:
        self._fn = ExportForward(model).eval()
        self.metadata.setdefault("names", {int(k): str(v) for k, v in model.names.items()})
        self.metadata.setdefault("stride", int(max(model.strides, default=1)))
        self.metadata.setdefault("nc", int(model.nc))
        self.metadata.setdefault("task", model.task)
        self.metadata.setdefault("end2end", bool(model.end2end))
        if model.task == "pose":
            self.metadata.setdefault("kpt_shape", [int(v) for v in model.kpt_shape])

    def _init_live(self, model: nn.Module, imgsz: Optional[int], device) -> None:
        self.format = "torch"
        self.device = model.device
        if device is not None and _indexed(torch.device(device)) != self.device:
            raise ValueError(f"the model lies on {self.device}, not on {device}")
        self._adopt(model)
        if imgsz:
            self.metadata["imgsz"] = [int(imgsz)] * 2

    def _init_pt2(self, path: Path) -> None:
        self.format = "pt2"
        program = torch.export.load(str(path))
        tensors = [*program.state_dict.values(), *program.constants.values()]
        dev = next((t.device for t in tensors if isinstance(t, torch.Tensor)), self.device)
        if dev != self.device:
            raise ValueError(f"{path} was exported on {dev}: load it with device={str(dev)!r}")
        self._fn = program.module()

    def _init_checkpoint(self, path: Path) -> None:
        from ..engine.model import YOLO

        self.format = "pt" if path.suffix == ".pt" else "ckpt"
        y = YOLO(str(path), device=self.device)
        self._adopt(y.model)
        if "imgsz" in y.overrides:
            self.metadata.setdefault("imgsz", [int(y.overrides["imgsz"])] * 2)

    # -- uniform inference --------------------------------------------------
    def __call__(self, im):
        """numpy float32 output(s) of uint8 frames: one array, or the
        (prediction, prototypes) pair of a segmentation model or program."""
        x = torch.as_tensor(np.asarray(im) if not isinstance(im, torch.Tensor) else im)
        with torch.inference_mode():
            out = self._fn(x.to(device=self.device, dtype=torch.uint8))
        if isinstance(out, (tuple, list)):
            return tuple(t.float().cpu().numpy() for t in out)
        return out.float().cpu().numpy()

    def warmup(self, imgsz=(1, 640, 640, 3)) -> "Backend":
        """One forward of zero frames: the program's batch (or one frame) at its imgsz."""
        if self.imgsz:
            imgsz = (max(int(self.metadata.get("batch", 1)), 1), int(self.imgsz[0]), int(self.imgsz[1]), 3)
        self(np.zeros(imgsz, np.uint8))
        return self


class ProgramModel(nn.Module):
    """A `.pt2` program (Backend) as the model the predictor drives:
    forward takes the predictor's (B, 3, H, W) float32 frames in [0, 1]
    (NHWC memory), turns them back into the uint8 frames they were made from
    (x * 255, rounded: exact in fp32), runs the program (a static program
    in chunks of its batch, the last padded with zero frames) and returns
    the live model's eval layout: (prediction, None), a classify program's
    (B, nc) softmax alone, an RT-DETR program's (queries, None) (its
    sidecar's `is_rtdetr`: the predictor's RT-DETR path), a YOLOv10 program's
    (detections, None), or a segmentation program's (prediction, (None,
    None, prototypes)); a pose program's prediction carries its keypoints,
    whose `kpt_shape` the sidecar gives, an OBB program's its angles (the
    predictor's NMS is then rotated). Program outputs are float32, as
    the live forward's decoded ones are, so the predictor's NMS, masks and
    keypoints are the live model's. A program exported with nms=True (xywh top-k without NMS) is
    refused: serve it with Backend."""

    def __init__(self, path, device=None):
        super().__init__()
        self.backend = Backend(path, device=device)
        md = self.backend.metadata
        if md.get("nms") and not md.get("end2end"):
            raise ValueError(f"{path} was exported with nms=True (the NMS-free top-k in xywh): serve it with "
                             "Backend, not YOLO")
        self.program = self.backend._fn
        self.names = self.backend.names
        self.nc = self.backend.nc
        self.task = self.backend.task
        self.kpt_shape = tuple(md["kpt_shape"]) if self.task == "pose" else None
        self.end2end = bool(md.get("end2end", False))
        self.is_rtdetr = bool(md.get("is_rtdetr", False))  # the predictor then stretches frames and keeps queries
        self.strides = (self.backend.stride,)
        self.batch = int(md.get("batch", -1))
        self.dtype = torch.float32

    @property
    def device(self) -> torch.device:
        return self.backend.device

    @property
    def is_fused(self) -> bool:
        """A program runs as it was exported: the predictor never folds it."""
        return True

    def fuse(self) -> "ProgramModel":
        return self

    def forward(self, x: torch.Tensor):
        img = (x.float().permute(0, 2, 3, 1) * 255.0).round().to(torch.uint8)
        n = img.shape[0]
        if self.batch > 0:
            chunks = [img[i:i + self.batch] for i in range(0, n, self.batch)]
            chunks[-1] = torch.cat([chunks[-1], chunks[-1].new_zeros((self.batch - len(chunks[-1]), *img.shape[1:]))])
            outs = [self.program(c) for c in chunks]
            out = (tuple(torch.cat(t)[:n] for t in zip(*outs)) if isinstance(outs[0], (tuple, list))
                   else torch.cat(outs)[:n])
        else:
            out = self.program(img)
        if self.task == "segment":
            return out[0], (None, None, out[1])
        return out if self.task == "classify" else (out, None)

    def predict_augment(self, x):
        raise NotImplementedError("augment=True needs the live model: a program holds one scale")

    def set_classes(self, names, embeddings=None):
        raise ValueError("a .pt2 program holds the text features it was exported with: set the classes on the live "
                         "model (YOLO(...).set_classes) and export it again")


def check_class_names(names, nc: Optional[int] = None) -> Dict[int, str]:
    """A names mapping as {int: str} (JAX nn/autobackend.py check_class_names):
    a list becomes an index dict, string keys ints; an index out of range
    of nc raises KeyError."""
    if isinstance(names, (list, tuple)):
        names = dict(enumerate(names))
    names = {int(k): str(v) for k, v in dict(names).items()}
    n = nc if nc is not None else (max(names) + 1 if names else 0)
    if names and max(names) >= n:
        raise KeyError(f"class indices {sorted(names)} invalid for nc={n} dataset")
    return names


def default_class_names(data=None) -> Dict[int, str]:
    """The class names of a data YAML, else COCO's 80 (cfg/datasets/coco8.yaml):
    also where the data YAML cannot be read, as the JAX package falls back."""
    if data is not None:
        try:
            from ..data.dataset import check_det_dataset

            return check_class_names(check_det_dataset(str(data))["names"])
        except Exception:  # noqa: BLE001  the JAX package falls back to COCO's names on any failure
            pass
    coco = Path(__file__).resolve().parent.parent / "cfg" / "datasets" / "coco8.yaml"
    return check_class_names(yaml.safe_load(coco.read_text())["names"])
