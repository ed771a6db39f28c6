"""Exporter of the PyTorch port: the model as a torch.export program (`.pt2`).

Counterpart of the JAX package's engine/exporter.py (its Exporter, :52-211,
and export_formats, :320-339). The JAX package writes StableHLO, a TF
SavedModel, a frozen pb and TFLite; the port writes one format, `pt2`: a
`torch.export` program of ExportForward, saved with `torch.export.save`.
The program takes (B, H, W, 3) uint8 NHWC frames and returns float32
(B, 4 + nc, A), the Detect layout (xywh pixels, then class sigmoids), or
with `nms` the (B, max_det, 6) of ops/nms.py e2e_postprocess. A
segmentation model's program returns two float32 outputs: the
(B, 4 + nc + nm, A) prediction (the Detect layout, then the mask
coefficients) and the prototypes (B, nm, H/4, W/4), so that masks can be
made from it (the JAX exporter's seg program returns the prediction only);
`nms=True` on it raises ValueError, as in the JAX exporter. A pose
model's program returns one float32 (B, 4 + nc + nk * nd, A): the Detect
layout followed by the decoded keypoints (x, y in input pixels and, where
nd is 3, the visibility sigmoid); its sidecar says `task: pose` and gives
`kpt_shape` (as the reference's exporter writes it; the JAX exporter does
not), and `nms=True` on it raises too. An OBB model's program returns
one float32 (B, 4 + nc + 1, A): the rotated boxes' centre and size in
input pixels, the class sigmoids and the angle in radians; its sidecar
says `task: obb` and gives that layout, and `nms=True` on it raises, as
for every task but detect (the JAX exporter's :90-91). A classify
model's program returns the float32 (B, nc) softmax; its sidecar says
`task: classify` and stride 1 (no stride rounds its imgsz; the JAX
exporter writes 32). A YOLOv10
model's program returns its head's (B, 300, 6) detections (xyxy pixels,
score, class: NMS-free); its sidecar says `end2end`, and `nms=True` on it
warns and is dropped (the JAX exporter would run e2e_postprocess on those
detections as if they were (B, 4 + nc, A)). An RT-DETR model's program
returns its decoder's (B, nq, 4 + nc) queries (normalised xywh, then the
class sigmoids: NMS-free), with the encoder's stable top-k and the
deformable sampling's grid_sample in the graph; its sidecar says
`is_rtdetr` and `nq`, and `nms=True` on it raises (nothing to suppress;
the JAX exporter has no such check). A YOLO-World model's program holds
the text features set before export as a constant (the prompts of its
sidecar's names) and returns the Detect layout at nc = their number. The SwinBlocks
stay in the graph as the port's operators (`yolov8_cbam_swin::swin_block_fwd`,
`yolov8_cbam_swin::swin_block_int8`, ops/swin.py and ops/swin_int8.py), so
the loaded program launches K1, or K4 when int8, on the card. Load it with
nn/autobackend.py Backend, which imports those operators first.

Options, resolved as the JAX exporter resolves them (:61-93):
  batch=N     the program takes N frames and refuses any other batch
  dynamic     one program for any batch (torch.export.Dim on the batch)
  half        bf16 compute and bf16 weight matrices (K1 in its fast mode,
              as bf16 serving runs it)
  int8        a BN-folded fp32 copy calibrated and quantized by
              ops/quant.py quantize_model, on `data`'s val images or on the
              JAX exporter's synthetic frames (numpy default_rng(0), 2
              batches of 8 at imgsz), which also stand in, with a warning,
              where `data` cannot be read; needs fp32 weights; takes a
              static batch or dynamic
  nms         the program ends in e2e_postprocess with max_det (dropped,
              with a warning, for a YOLOv10 model)
half with int8 turns half off, with a warning; keras=True raises; the
torch-ecosystem keys (optimize, simplify, opset, workspace, dnn) warn when
changed from their defaults. The caller's model is never altered: the
exporter works on a copy. Every program is written with a sidecar
`<file>.yaml` holding the JAX package's metadata keys.

A program is tied to the device it was exported on (its constants and
kernels live there): export on the card to serve on the card.
"""

from __future__ import annotations

import copy
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import yaml

from ..nn.tasks import EnsembleModel
from ..ops.nms import e2e_postprocess
from ..ops.quant import is_quantized, quantize_model
from ..utils.callbacks import default_callbacks, run_callbacks

FORMATS = {"pt2": {"batch", "dynamic", "half", "int8", "nms"}}  # format: the options it takes
TORCH_ONLY_KEYS = (("simplify", True), ("opset", None), ("optimize", False), ("workspace", None), ("dnn", False))


class ExportForward(nn.Module):
    """uint8 (B, H, W, 3) RGB frames -> the model's float32 (B, 4 + nc, A)
    (a YOLOv10 model's (B, 300, 6) detections; a segmentation model's
    (B, 4 + nc + nm, A) and its float32 prototypes (B, nm, H/4, W/4); a
    pose model's (B, 4 + nc + nk * nd, A); an OBB model's (B, 4 + nc + 1,
    A); an RT-DETR model's (B, nq, 4 + nc)), or
    with nms e2e_postprocess's (B, max_det, 6): the frames cast to the
    model's dtype, then divided by 255, as the JAX exporter's forward does."""

    def __init__(self, model: nn.Module, nms: bool = False, max_det: int = 300):
        super().__init__()
        self.model = model
        self.nms = nms
        self.max_det = max_det

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = img.permute(0, 3, 1, 2).to(self.model.dtype) / 255.0
        out = self.model(x)
        if self.model.task == "classify":  # the (B, nc) softmax
            return out.float()
        pred = out[0].float()
        if self.nms:
            return e2e_postprocess(pred, self.max_det, self.model.nc)
        return (pred, out[1][2].float()) if self.model.task == "segment" else pred


class Exporter:
    def __init__(self, model: nn.Module, args, callbacks=None):
        self.model = model
        self.args = args
        self.callbacks = callbacks if callbacks is not None else default_callbacks()
        self.path = None

    def _resolve_options(self) -> Dict:
        a = self.args
        opts = {"batch": int(a.batch or 1), "dynamic": bool(a.dynamic), "half": bool(a.half),
                "int8": bool(a.int8), "nms": bool(a.nms)}
        if a.keras:
            raise ValueError("keras=True is not supported by the port's exporter: it writes format='pt2' only")
        for k, default in TORCH_ONLY_KEYS:
            if getattr(a, k) != default:
                print(f"WARNING: export arg {k}={getattr(a, k)!r} applies to other torch export formats; ignored")
        if opts["half"] and opts["int8"]:
            print("WARNING: half=True and int8=True are mutually exclusive, setting half=False")
            opts["half"] = False
        if opts["nms"] and self.model.task != "detect":
            raise ValueError(f"nms=True export requires a detect-task model, not a {self.model.task} model")
        if opts["nms"] and self.model.is_rtdetr:
            raise ValueError("nms=True export of an RT-DETR model: its decoder's queries are NMS-free, there is "
                             "nothing to suppress; export it with nms=False")
        if opts["nms"] and self.model.end2end:
            print("WARNING: nms=True on a YOLOv10 (end2end) model: its head gives the NMS-free detections "
                  "already, setting nms=False")
            opts["nms"] = False
        return opts

    def _calib_batches(self) -> List[np.ndarray]:
        """Calibration frames for int8: up to 32 val (else train) images of
        `data` in batches of 8, letterboxed to imgsz; without data, or where
        reading `data` fails or gives no image (with a warning, as the JAX
        exporter does), the JAX exporter's synthetic frames, so both packages
        calibrate on the same."""
        imgsz = int(self.args.imgsz)
        if self.args.data:
            try:
                from ..data.dataset import DataLoader, YOLODataset, check_det_dataset

                info = check_det_dataset(self.args.data)
                ds = YOLODataset(info.get("val") or info["train"], imgsz=imgsz, max_gt=8, nc=int(info["nc"]))
                batches, n = [], 0
                for b in DataLoader(ds, 8, train=False, workers=2):
                    batches.append(b["img"])
                    n += len(b["img"])
                    if n >= 32:
                        break
                if batches:
                    return batches
            except Exception as e:  # noqa: BLE001  the JAX exporter falls back on any failure of the data
                print(f"WARNING: int8 calibration on data={self.args.data!r} failed ({e}); using synthetic frames")
        else:
            print("WARNING: int8=True without data=; calibrating on synthetic frames")
        rng = np.random.default_rng(0)
        return [rng.integers(0, 255, (8, imgsz, imgsz, 3), dtype=np.uint8) for _ in range(2)]

    def export_model(self, opts: Dict) -> nn.Module:
        """A copy of the model with half or int8 applied."""
        m = copy.deepcopy(self.model)
        if opts["half"] and (m.dtype != torch.bfloat16 or m.param_dtype != torch.bfloat16):
            m.dtype = m.param_dtype = torch.bfloat16
            m._cast(torch.bfloat16)
        if opts["int8"]:
            if is_quantized(m):
                raise ValueError("int8=True: the model is quantized already; export it with int8=False")
            quantize_model(m.fuse(), self._calib_batches())  # raises for weights other than fp32
        return m.eval()

    def _metadata(self, imgsz: int, opts: Dict, quantized: bool) -> Dict:
        md = {
            "description": "improving_yolov8_cbam_swinblock_tpu_torch export (torch.export program)",
            "stride": int(max(self.model.strides, default=1)),  # a classify model's 1: imgsz is not rounded
            "task": self.model.task,
            "batch": -1 if opts["dynamic"] else opts["batch"],
            "imgsz": [imgsz, imgsz],
            "names": {int(k): str(v) for k, v in self.model.names.items()},
            "nc": int(self.model.nc),
            "half": opts["half"],
            "int8": quantized,
            "nms": opts["nms"],
            "layout": ("NHWC uint8 in, (B, max_det, 6) out (xyxy pixels, conf, cls: the YOLOv10 head's NMS-free "
                       "top-k)" if self.model.end2end
                       else "NHWC uint8 in, (B, nq, 4+nc) out (normalised xywh + cls sigmoid: the RT-DETR decoder's "
                       "NMS-free queries)" if self.model.is_rtdetr
                       else "NHWC uint8 in, (B, max_det, 6) out (xywh pixels, conf, cls: the NMS-free top-k of "
                       "e2e_postprocess)" if opts["nms"]
                       else "NHWC uint8 in, (B, 4+nc+nm, A) out (xywh pixels + cls sigmoid + mask coefficients) "
                       "and (B, nm, H/4, W/4) out (mask prototypes)" if self.model.task == "segment"
                       else "NHWC uint8 in, (B, 4+nc+nk*nd, A) out (xywh pixels + cls sigmoid + keypoints: x, y "
                       "pixels and, where nd is 3, the visibility sigmoid)" if self.model.task == "pose"
                       else "NHWC uint8 in, (B, 4+nc+1, A) out (rotated boxes' xywh pixels + cls sigmoid + angle "
                       "in radians)" if self.model.task == "obb"
                       else "NHWC uint8 in, (B, nc) out (class softmax)" if self.model.task == "classify"
                       else "NHWC uint8 in, (B, 4+nc, A) out (xywh pixels + cls sigmoid)"),
        }
        if self.model.task == "pose":  # the reference's key, which the JAX package's sidecar lacks
            md["kpt_shape"] = [int(v) for v in self.model.kpt_shape]
        if self.model.end2end:  # a key the JAX package's sidecar lacks, written where it is true only
            md.update(end2end=True, max_det=int(self.model.model[-1].max_det))
        elif self.model.is_rtdetr:  # the same: the queries need no NMS
            md.update(is_rtdetr=True, nq=int(self.model.model[-1].nq))
        elif opts["nms"]:
            md["max_det"] = int(self.args.max_det)
        return md

    def __call__(self) -> str:
        run_callbacks(self.callbacks, "on_export_start", self)
        fmt = str(self.args.format).lower()
        if fmt not in FORMATS:  # the JAX package's stablehlo, saved_model, tflite and pb too
            raise ValueError(f"unsupported export format {fmt!r}; the port exports format='pt2' (a torch.export "
                             "program) only")
        if isinstance(self.model, EnsembleModel):
            raise NotImplementedError("exporting an ensemble is not supported: export one member")
        opts = self._resolve_options()
        imgsz = int(self.args.imgsz)
        t0 = time.time()
        tag = "".join(s for s, on in (("_int8", opts["int8"]), ("_half", opts["half"]), ("_nms", opts["nms"])) if on)
        out_dir = Path(self.args.project or ".")
        model = self.export_model(opts)
        path = self.export_pt2(model, out_dir / f"model_{imgsz}{tag}.pt2", imgsz, opts)
        Path(f"{path}.yaml").write_text(yaml.safe_dump(self._metadata(imgsz, opts, is_quantized(model))))
        print(f"export pt2 done in {time.time() - t0:.1f}s -> {path}")
        self.path = str(path)
        run_callbacks(self.callbacks, "on_export_end", self)
        return str(path)

    def export_pt2(self, model: nn.Module, path: Path, imgsz: int, opts: Dict) -> Path:
        """torch.export of ExportForward(model) on the model's device, saved to
        `path`. A dynamic program is traced at batch 2 (a batch of 1 would be
        specialised) and takes any batch. One forward first fills the tables
        that RT-DETR's modules cache per map size (their positions and
        anchors), so that the program holds them as constants."""
        fwd = ExportForward(model, opts["nms"], int(self.args.max_det)).eval()
        b = 2 if opts["dynamic"] else opts["batch"]
        img = torch.zeros((b, imgsz, imgsz, 3), dtype=torch.uint8, device=model.device)
        if model.is_rtdetr:
            with torch.no_grad():
                fwd(img)
        dims = ({0: torch.export.Dim("batch", min=1)},) if opts["dynamic"] else None
        program = torch.export.export(fwd, (img,), dynamic_shapes=dims, strict=False)
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.export.save(program, str(path))
        return path


def export_formats() -> Dict[str, list]:
    """The formats table (JAX engine/exporter.py:320-339): the port's one
    artifact format and its own checkpoints, column by column."""
    rows = [["PyTorch export program", "pt2", ".pt2", True, True, sorted(FORMATS["pt2"])],
            ["PyTorch", "torch", ".pt", True, True, []],
            ["Checkpoint", "ckpt", ".ckpt", True, True, []]]
    return {col: [r[i] for r in rows] for i, col in enumerate(("Format", "Argument", "Suffix", "CPU", "GPU",
                                                                 "Arguments"))}
