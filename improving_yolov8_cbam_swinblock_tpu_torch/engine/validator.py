"""Detection validator: forward and NMS on the model's device, matching and AP on the host.

Counterpart of the JAX package's engine/validator.py (_iter_val_batches and
DetectionValidator, without sharding): letterboxed batches -> forward (eval
mode) -> greedy NMS at conf 0.001, iou 0.7, `max_det`, multi-label when
nc > 1 (a YOLOv10 model's head detections gated at conf 0.001 instead; an
RT-DETR model's every query, xywh scaled by the input's size, sorted by
score, with no NMS and no gate) ->
boxes clipped to each image's content region (ratio_pad) -> TP matching
against the GT in letterboxed pixels over 10 IoU thresholds ->
ap_per_class. on_val_batch_start and on_val_batch_end fire around each
batch on `callbacks`. With `plots`, the confusion matrix and the PR, P, R
and F1 curves, and with `save_json` the kept detections (letterboxed
pixels, one running image id per image) as predictions.json, go to
<project or runs/detect>/<name or val>, as in the JAX package.

`times` holds the seconds of the last call: waiting for the loader, the
device part (forward, NMS and the copy of the detections to the host) and
the host part (matching and AP).

SegmentationValidator (the JAX package's, engine/validator.py:262-331)
adds the masks: each kept detection's mask at the prototypes' resolution
(process_mask, > 0.5) is matched by mask IoU against the loader's overlap
map (`seg_map`, imgsz / 4), and its metrics are the box and the mask mAP:
fitness is their sum, and `mAP50-95` is the mask's. It draws no plots and
writes no JSON, as in the JAX package. PoseValidator (the JAX package's,
engine/validator.py:332-395) matches each kept detection's keypoints (the
NMS rows' columns after the class, in letterboxed pixels) by object
keypoint similarity against the loader's (max_gt, nk, 3) targets, with
each GT box's area times 0.53 and the COCO sigmas where nk is 17, else
1 / nk; its metrics are the box and the keypoint mAP (fitness their sum,
`mAP50-95` the keypoints'), without plots or JSON. OBBValidator (the JAX
package's, engine/validator.py:396-438) runs the rotated NMS (probiou,
multi-label where nc > 1) and matches each kept box (xywh and the angle,
in letterboxed pixels) by probiou against the loader's normalised xywhr
targets scaled by imgsz; its metrics are the box keys, without plots or
JSON. ClassificationValidator gives a classify model's top-1 and top-5
accuracy. TASK_VALIDATORS picks the validator of a model's task.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from pathlib import Path

from ..ops.boxes import detr_rows, process_mask, xywh2xyxy
from ..ops.nms import non_max_suppression
from ..utils.callbacks import run_callbacks
from ..utils.metrics import (OKS_SIGMA, ClassifyMetrics, ConfusionMatrix, DetMetrics, box_iou_np, kpt_iou_np,
                             mask_iou_np, match_predictions, plot_pr_curves, probiou_np)


class DetectionValidator:
    writes_files = True  # plots and predictions.json, where the args ask for them

    def __init__(self, model, loader, args, callbacks: Optional[Dict] = None, owner=None):
        self.model = model
        self.loader = loader
        self.args = args
        self.callbacks = callbacks  # fire on_val_batch_start / _end on this bus
        self.owner = owner  # what the events receive: the trainer, or this validator
        self.confusion_matrix: Optional[ConfusionMatrix] = None  # with plots, per call
        self.json_dets: Optional[list] = None  # with save_json, per call
        self.image_id = 0
        self.conf = 0.001
        self.iou = 0.7
        self.metrics = DetMetrics(model.names)
        self.seen = 0
        self.standalone = True  # per-class rows in the table; the trainer prints the 'all' row only
        self.times = {"loader": 0.0, "device": 0.0, "host": 0.0}

    @torch.inference_mode()
    def forward_nms(self, img: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, max_det, 6) detections in letterboxed pixels, on the host."""
        m = self.model
        x = torch.as_tensor(img, device=m.device).permute(0, 3, 1, 2).to(m.dtype) / 255.0
        pred, _ = m(x)
        if m.is_rtdetr:  # every query, highest score first (stable); no NMS, no conf gate
            dets = detr_rows(pred, (img.shape[2], img.shape[1]))
            order = torch.sort(dets[..., 4], dim=-1, descending=True, stable=True)[1]
            return dets.gather(1, order[..., None].expand(-1, -1, 6)).cpu().numpy()
        if m.end2end:  # YOLOv10: the head's detections, gated by the val conf only
            return (pred * (pred[..., 4:5] > self.conf)).cpu().numpy()
        dets = non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou, max_det=int(self.args.max_det),
                                   nc=m.nc, multi_label=m.nc > 1)
        return dets.cpu().numpy()

    def update_metrics(self, dets: np.ndarray, batch: Dict[str, np.ndarray]) -> None:
        """Match one batch's detections to its GT and add them to the metrics
        (and to the confusion matrix and the JSON records, where asked for)."""
        fh, fw = batch["img"].shape[1:3]
        frame = np.array([fw, fh, fw, fh], np.float32)  # GT scale: the letterboxed (maybe rect) frame
        for i in range(dets.shape[0]):
            det = dets[i]
            det = det[det[:, 4] > 0]
            if "ratio_pad" in batch:  # clip to the content region [pad, pad + orig * r]
                r, padw, padh = batch["ratio_pad"][i]
                oh, ow = batch["orig_shape"][i]
                det = det.copy()
                det[:, [0, 2]] = det[:, [0, 2]].clip(padw, padw + ow * r)
                det[:, [1, 3]] = det[:, [1, 3]].clip(padh, padh + oh * r)
            gt_m = batch["mask"][i] > 0
            gt_cls = batch["cls"][i][gt_m].astype(int)
            gt_xyxy = xywh2xyxy(torch.from_numpy(batch["bboxes"][i][gt_m] * frame)).numpy()
            if self.confusion_matrix is not None:
                self.confusion_matrix.process_batch(det, gt_xyxy, gt_cls)
            if self.json_dets is not None and len(det):
                self.json_dets.append({"image_id": self.image_id, "boxes": det[:, :6]})
            self.image_id += 1
            if len(det) == 0:
                if len(gt_cls):
                    self.metrics.update(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0), gt_cls)
                continue
            tp = match_predictions(det[:, 5].astype(int), gt_cls, box_iou_np(gt_xyxy, det[:, :4]))
            self.metrics.update(tp, det[:, 4], det[:, 5].astype(int), gt_cls)

    def init_metrics(self) -> None:
        self.metrics = DetMetrics(self.model.names)

    def compute(self) -> Dict[str, float]:
        return self.metrics.compute()

    def __call__(self) -> Dict[str, float]:
        self.model.eval()
        self.init_metrics()
        self.seen = 0
        plots, save_json = (bool(self.args.plots), bool(self.args.save_json)) if self.writes_files else (False, False)
        self.confusion_matrix = ConfusionMatrix(self.model.nc) if plots else None
        self.json_dets = [] if save_json else None
        self.image_id = 0
        owner = self.owner if self.owner is not None else self
        times = {"loader": 0.0, "device": 0.0, "host": 0.0}
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            t1 = time.perf_counter()
            times["loader"] += t1 - t0
            if batch is None:
                break
            if self.callbacks is not None:
                run_callbacks(self.callbacks, "on_val_batch_start", owner)
            self.seen += int(batch["img"].shape[0])
            dets = self.forward_nms(batch["img"])
            t2 = time.perf_counter()
            self.update_metrics(dets, batch)
            times["device"] += t2 - t1
            times["host"] += time.perf_counter() - t2
            if self.callbacks is not None:
                run_callbacks(self.callbacks, "on_val_batch_end", owner)
        t0 = time.perf_counter()
        out = self.compute()
        times["host"] += time.perf_counter() - t0
        self.times = times
        self.print_results(out)
        self.json_path = None
        if save_json and self.json_dets:
            from ..utils.coco_json import detections_to_coco_json

            self.json_path = detections_to_coco_json(self.json_dets, str(self.save_dir() / "predictions.json"))
        if plots:
            self.confusion_matrix.plot(str(self.save_dir() / "confusion_matrix.png"), self.model.names)
            if self.metrics.result is not None:
                plot_pr_curves(self.metrics.result, str(self.save_dir()), self.model.names)
        return out

    def save_dir(self) -> Path:
        """Where plots and predictions.json go: <project or runs/detect>/<name or val>."""
        d = Path(self.args.project or "runs/detect") / (self.args.name or "val")
        d.mkdir(parents=True, exist_ok=True)
        return d

    def print_results(self, out: Dict[str, float]) -> None:
        """The reference's metrics table: the 'all' row, and a row per class
        on a standalone val with more than one class."""
        if not getattr(self.args, "verbose", True):
            return
        keys = ("precision", "recall", "mAP50", "mAP50-95")
        pf = "%22s" + "%11i" * 2 + "%11.3g" * 4
        print(("%22s" + "%11s" * 6) % ("Class", "Images", "Instances", "Box(P", "R", "mAP50", "mAP50-95)"))
        nt = sum(len(s[3]) for s in self.metrics.stats)
        print(pf % ("all", self.seen, nt, *(out[k] for k in keys)))
        if self.standalone and len(self.metrics.per_class) > 1:
            for name, v in self.metrics.per_class.items():
                print(pf % (name, self.seen, v["n"], *(v[k] for k in keys)))


class SegmentationValidator(DetectionValidator):
    """Box and mask mAP of a segmentation model (the module docstring)."""

    writes_files = False

    def init_metrics(self) -> None:
        self.box_m, self.mask_m = DetMetrics(self.model.names), DetMetrics(self.model.names)
        self.metrics = self.box_m

    @torch.inference_mode()
    def forward_nms(self, img: np.ndarray):
        """(B, H, W, 3) uint8 RGB -> ((B, max_det, 6) detections, each image's
        (n, H / 4, W / 4) bool masks of its n kept rows), on the host."""
        m = self.model
        x = torch.as_tensor(img, device=m.device).permute(0, 3, 1, 2).to(m.dtype) / 255.0
        pred, (_, _, proto) = m(x)
        dets = non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou, max_det=int(self.args.max_det),
                                   nc=m.nc, multi_label=m.nc > 1)
        hw = tuple(x.shape[2:])
        masks = []
        for d, p in zip(dets, proto):
            d = d[d[:, 4] > 0]
            masks.append((process_mask(p, d[:, 6:], d[:, :4], hw) > 0.5).cpu().numpy())
        return dets[..., :6].cpu().numpy(), masks

    def update_metrics(self, out, batch: Dict[str, np.ndarray]) -> None:
        """Match one batch's detections by box IoU and by mask IoU against the
        overlap map, as the JAX package's SegmentationValidator does (no
        clip to the content region; GT boxes scaled by imgsz)."""
        dets, pmasks = out
        imgsz = int(self.args.imgsz)
        for i in range(dets.shape[0]):
            det = dets[i][dets[i][:, 4] > 0]
            pm = pmasks[i]
            gt_sel = batch["mask"][i] > 0
            gt_cls = batch["cls"][i][gt_sel].astype(int)
            if len(det) == 0:
                if len(gt_cls):
                    z = np.zeros((0, 10), bool)
                    self.box_m.update(z, np.zeros(0), np.zeros(0), gt_cls)
                    self.mask_m.update(z, np.zeros(0), np.zeros(0), gt_cls)
                continue
            gt_xyxy = xywh2xyxy(torch.from_numpy(batch["bboxes"][i][gt_sel])).numpy() * imgsz
            pred_cls = det[:, 5].astype(int)
            tp_b = match_predictions(pred_cls, gt_cls, box_iou_np(gt_xyxy, det[:, :4]))
            gids = np.nonzero(gt_sel)[0]
            gm = batch["seg_map"][i][None] == (gids[:, None, None] + 1)  # (G, h4, w4)
            hw = gm.shape[1] * gm.shape[2]  # explicit: JAX's reshape(G, -1) fails on an image without GT
            tp_m = match_predictions(pred_cls, gt_cls, mask_iou_np(gm.reshape(len(gids), hw), pm.reshape(len(det), hw)))
            self.box_m.update(tp_b, det[:, 4], pred_cls, gt_cls)
            self.mask_m.update(tp_m, det[:, 4], pred_cls, gt_cls)

    def compute(self) -> Dict[str, float]:
        b, m = self.box_m.compute(), self.mask_m.compute()
        out = {f"{k}(B)": v for k, v in b.items() if k != "fitness"}
        out.update({f"{k}(M)": v for k, v in m.items() if k != "fitness"})
        out["fitness"] = b["fitness"] + m["fitness"]
        out["mAP50-95"] = m["mAP50-95"]  # the headline: the mask mAP
        return out

    def print_results(self, out: Dict[str, float]) -> None:
        if not getattr(self.args, "verbose", True):
            return
        pf = "%22s" + "%11i" * 2 + "%11.3g" * 8
        print(("%22s" + "%11s" * 10) % ("Class", "Images", "Instances", "Box(P", "R", "mAP50", "mAP50-95)",
                                        "Mask(P", "R", "mAP50", "mAP50-95)"))
        nt = sum(len(st[3]) for st in self.box_m.stats)
        print(pf % ("all", self.seen, nt, *(out[f"{k}({t})"] for t in "BM"
                                              for k in ("precision", "recall", "mAP50", "mAP50-95"))))


class PoseValidator(DetectionValidator):
    """Box and OKS keypoint mAP of a pose model (the module docstring)."""

    writes_files = False

    def init_metrics(self) -> None:
        self.box_m, self.pose_m = DetMetrics(self.model.names), DetMetrics(self.model.names)
        self.metrics = self.box_m
        nk = self.model.kpt_shape[0]
        self.sigma = OKS_SIGMA if nk == 17 else np.ones(nk) / nk

    def update_metrics(self, dets: np.ndarray, batch: Dict[str, np.ndarray]) -> None:
        """Match one batch's detections by box IoU and by OKS, as the JAX
        package's PoseValidator does (no clip to the content region; GT boxes
        and keypoints scaled by imgsz)."""
        imgsz = int(self.args.imgsz)
        nk, nd = self.model.kpt_shape
        for i in range(dets.shape[0]):
            det = dets[i][dets[i][:, 4] > 0]
            gt_sel = batch["mask"][i] > 0
            gt_cls = batch["cls"][i][gt_sel].astype(int)
            if len(det) == 0:
                if len(gt_cls):
                    z = np.zeros((0, 10), bool)
                    self.box_m.update(z, np.zeros(0), np.zeros(0), gt_cls)
                    self.pose_m.update(z, np.zeros(0), np.zeros(0), gt_cls)
                continue
            gt_xyxy = xywh2xyxy(torch.from_numpy(batch["bboxes"][i][gt_sel] * imgsz)).numpy()
            gt_kpts = batch["kpts"][i][gt_sel].copy()  # (G, nk, 3) normalised
            gt_kpts[..., :2] *= imgsz
            pred_cls = det[:, 5].astype(int)
            tp_b = match_predictions(pred_cls, gt_cls, box_iou_np(gt_xyxy, det[:, :4]))
            area = (gt_xyxy[:, 2] - gt_xyxy[:, 0]) * (gt_xyxy[:, 3] - gt_xyxy[:, 1]) * 0.53
            oks = kpt_iou_np(gt_kpts, det[:, 6:6 + nk * nd].reshape(len(det), nk, nd), area, self.sigma)
            tp_p = match_predictions(pred_cls, gt_cls, oks)
            self.box_m.update(tp_b, det[:, 4], pred_cls, gt_cls)
            self.pose_m.update(tp_p, det[:, 4], pred_cls, gt_cls)

    def compute(self) -> Dict[str, float]:
        b, p = self.box_m.compute(), self.pose_m.compute()
        out = {f"{k}(B)": v for k, v in b.items() if k != "fitness"}
        out.update({f"{k}(P)": v for k, v in p.items() if k != "fitness"})
        out["fitness"] = b["fitness"] + p["fitness"]
        out["mAP50-95"] = p["mAP50-95"]  # the headline: the keypoint mAP
        return out

    def print_results(self, out: Dict[str, float]) -> None:
        if not getattr(self.args, "verbose", True):
            return
        pf = "%22s" + "%11i" * 2 + "%11.3g" * 8
        print(("%22s" + "%11s" * 10) % ("Class", "Images", "Instances", "Box(P", "R", "mAP50", "mAP50-95)",
                                        "Pose(P", "R", "mAP50", "mAP50-95)"))
        nt = sum(len(st[3]) for st in self.box_m.stats)
        print(pf % ("all", self.seen, nt, *(out[f"{k}({t})"] for t in "BP"
                                              for k in ("precision", "recall", "mAP50", "mAP50-95"))))


class OBBValidator(DetectionValidator):
    """Rotated-box mAP of an oriented-box model by probiou matching (the module docstring)."""

    writes_files = False

    @torch.inference_mode()
    def forward_nms(self, img: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, max_det, 7) rotated detections x, y,
        w, h, conf, cls, angle in letterboxed pixels, on the host."""
        m = self.model
        x = torch.as_tensor(img, device=m.device).permute(0, 3, 1, 2).to(m.dtype) / 255.0
        pred, _ = m(x)
        dets = non_max_suppression(pred, conf_thres=self.conf, iou_thres=self.iou, max_det=int(self.args.max_det),
                                   nc=m.nc, multi_label=m.nc > 1, rotated=True)
        return dets.cpu().numpy()

    def update_metrics(self, dets: np.ndarray, batch: Dict[str, np.ndarray]) -> None:
        """Match one batch's rotated detections by probiou, as the JAX
        package's OBBValidator does (GT xywh scaled by imgsz)."""
        imgsz = int(self.args.imgsz)
        for i in range(dets.shape[0]):
            det = dets[i][dets[i][:, 4] > 0]
            gt_sel = batch["mask"][i] > 0
            gt_cls = batch["cls"][i][gt_sel].astype(int)
            gt_r = batch["bboxes"][i][gt_sel].copy()  # (G, 5) normalised xywhr
            gt_r[:, :4] *= imgsz
            if len(det) == 0:
                if len(gt_cls):
                    self.metrics.update(np.zeros((0, 10), bool), np.zeros(0), np.zeros(0), gt_cls)
                continue
            iou = probiou_np(gt_r, np.concatenate([det[:, :4], det[:, 6:7]], 1))
            tp = match_predictions(det[:, 5].astype(int), gt_cls, iou)
            self.metrics.update(tp, det[:, 4], det[:, 5].astype(int), gt_cls)


class ClassificationValidator(DetectionValidator):
    """Top-1 and top-5 accuracy of a classify model (the JAX package's
    ClassificationValidator, engine/validator.py:64-103): each batch of the
    image-folder loader's (B, s, s, 3) uint8 RGB images / 255 goes through
    the eval forward (the softmax) on the model's device, and each image's
    top 5 classes are np.argsort(-probs)[:, :5] on the host, as the JAX
    validator ranks them. Every row of a batch counts, so the images that
    the last val batch wraps around to count twice, as in the JAX package.
    Returns top1, top5 and fitness, (top1 + top5) / 2 (ClassifyMetrics and
    the reference; the JAX validator's fitness is top1). No plots, no JSON."""

    writes_files = False

    def init_metrics(self) -> None:
        self.metrics = ClassifyMetrics()
        self.pred, self.targets = [], []

    @torch.inference_mode()
    def forward_nms(self, img: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> (B, min(5, nc)) class indices by falling probability, on the host."""
        m = self.model
        x = torch.as_tensor(img, device=m.device).permute(0, 3, 1, 2).to(m.dtype) / 255.0
        probs = m(x).float().cpu().numpy()
        return np.argsort(-probs, axis=-1)[:, :min(5, probs.shape[-1])]

    def update_metrics(self, topk: np.ndarray, batch: Dict[str, np.ndarray]) -> None:
        self.pred.append(topk)
        self.targets.append(np.asarray(batch["label"]))

    def compute(self) -> Dict[str, float]:
        """The hits over the images counted (exact ratios of counts, as the JAX validator's)."""
        n = sum(len(t) for t in self.targets)
        if n:
            topk, labels = np.concatenate(self.pred), np.concatenate(self.targets)
            self.metrics.top1 = int((topk[:, 0] == labels).sum()) / n
            self.metrics.top5 = int((topk == labels[:, None]).any(1).sum()) / n
        return {"top1": self.metrics.top1, "top5": self.metrics.top5, "fitness": self.metrics.fitness}

    def print_results(self, out: Dict[str, float]) -> None:
        if not getattr(self.args, "verbose", True):
            return
        print("%22s%11s%11s" % ("classes", "top1_acc", "top5_acc"))
        print("%22s%11.3g%11.3g" % ("all", out["top1"], out["top5"]))


TASK_VALIDATORS = {"detect": DetectionValidator, "segment": SegmentationValidator, "pose": PoseValidator,
                   "obb": OBBValidator, "classify": ClassificationValidator}
