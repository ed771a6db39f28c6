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
nms and for a YOLOv10 model or program (`end2end`). A checkpoint or model
runs as it is, unfused, in the dtype it was built with (fp32 for a JAX
checkpoint), as the JAX Backend runs its checkpoints. A program runs on the
device it was exported on.
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
        self.metadata.setdefault("stride", int(max(model.strides)))
        self.metadata.setdefault("nc", int(model.nc))
        self.metadata.setdefault("task", "detect")
        self.metadata.setdefault("end2end", bool(model.end2end))

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
    def __call__(self, im) -> np.ndarray:
        x = torch.as_tensor(np.asarray(im) if not isinstance(im, torch.Tensor) else im)
        with torch.inference_mode():
            out = self._fn(x.to(device=self.device, dtype=torch.uint8))
        return out.float().cpu().numpy()

    def warmup(self, imgsz=(1, 640, 640, 3)) -> "Backend":
        """One forward of zero frames: the program's batch (or one frame) at its imgsz."""
        if self.imgsz:
            imgsz = (max(int(self.metadata.get("batch", 1)), 1), int(self.imgsz[0]), int(self.imgsz[1]), 3)
        self(np.zeros(imgsz, np.uint8))
        return self


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
