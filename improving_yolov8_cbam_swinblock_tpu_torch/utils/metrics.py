"""Detection metrics: IoU matching over 10 thresholds, per-class AP (101-point
interpolation), DetMetrics, Metric and ValMetrics (a copy of the JAX
package's utils/metrics.py:16-156, 275-375, 459-547 and 703; numpy on the
host, as there). Plots, the confusion matrix and the segment, pose and OBB
metrics are not in the port.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def box_iou_np(box1: np.ndarray, box2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N,4),(M,4) xyxy -> (N,M) IoU."""
    lt = np.maximum(box1[:, None, :2], box2[None, :, :2])
    rb = np.minimum(box1[:, None, 2:], box2[None, :, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=2)
    a1 = np.prod(box1[:, 2:] - box1[:, :2], axis=1)
    a2 = np.prod(box2[:, 2:] - box2[:, :2], axis=1)
    return inter / (a1[:, None] + a2[None] - inter + eps)


IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


def match_predictions(pred_classes, true_classes, iou) -> np.ndarray:
    """TP matrix (npred, 10) over IoU thresholds 0.50:0.95
    (reference validator.py:256-298 greedy unique matching)."""
    correct = np.zeros((pred_classes.shape[0], IOU_THRESHOLDS.shape[0]), dtype=bool)
    correct_class = true_classes[:, None] == pred_classes[None, :]
    iou = iou * correct_class  # zero out wrong-class pairs
    for i, threshold in enumerate(IOU_THRESHOLDS):
        matches = np.nonzero(iou >= threshold)
        matches = np.array(matches).T
        if matches.shape[0]:
            if matches.shape[0] > 1:
                order = iou[matches[:, 0], matches[:, 1]].argsort()[::-1]
                matches = matches[order]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
            correct[matches[:, 1].astype(int), i] = True
    return correct


def compute_ap(recall: np.ndarray, precision: np.ndarray):
    """101-point interpolated AP (reference metrics.py:540-572)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(np.interp(x, mrec, mpre), x)  # noqa: NPY201
    return ap, mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps=1e-16) -> Dict:
    """Per-class precision/recall/AP (reference metrics.py:573-661)."""
    i = np.argsort(-conf)
    tp, conf, pred_cls = tp[i], conf[i], pred_cls[i]
    unique_classes, nt = np.unique(target_cls, return_counts=True)
    nc = unique_classes.shape[0]

    ap = np.zeros((nc, tp.shape[1]))
    p_curve = np.zeros((nc, 1000))
    r_curve = np.zeros((nc, 1000))
    prec_values = np.zeros((nc, 1000))  # precision at the recall grid (IoU .5)
    x = np.linspace(0, 1, 1000)
    for ci, c in enumerate(unique_classes):
        idx = pred_cls == c
        n_l = nt[ci]
        n_p = idx.sum()
        if n_p == 0 or n_l == 0:
            continue
        fpc = (1 - tp[idx]).cumsum(0)
        tpc = tp[idx].cumsum(0)
        recall = tpc / (n_l + eps)
        r_curve[ci] = np.interp(-x, -conf[idx], recall[:, 0], left=0)
        precision = tpc / (tpc + fpc)
        p_curve[ci] = np.interp(-x, -conf[idx], precision[:, 0], left=1)
        for j in range(tp.shape[1]):
            ap[ci, j], mpre, mrec = compute_ap(recall[:, j], precision[:, j])
            if j == 0:
                prec_values[ci] = np.interp(x, mrec, mpre)

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    i_best = smooth(f1_curve.mean(0), 0.1).argmax()
    p, r, f1 = p_curve[:, i_best], r_curve[:, i_best], f1_curve[:, i_best]
    return {
        "ap": ap,
        "p": p,
        "r": r,
        "f1": f1,
        "unique_classes": unique_classes.astype(int),
        "nt": nt,
        "p_conf_curve": p_curve,
        "r_conf_curve": r_curve,
        "f1_curve": f1_curve,
        "p_curve": prec_values,
        "r_curve_x": x,
    }


def smooth(y: np.ndarray, f: float = 0.05) -> np.ndarray:
    """Box-filter smoothing (reference metrics.py:467)."""
    nf = round(len(y) * f * 2) // 2 + 1
    p = np.ones(nf // 2)
    yp = np.concatenate((p * y[0], y, p * y[-1]), 0)
    return np.convolve(yp, np.ones(nf) / nf, mode="valid")


class DetMetrics:
    """mAP aggregation; fitness = 0.1*mAP50 + 0.9*mAP50-95
    (reference metrics.py:835-931). compute() also fills `self.box`, the
    reference's attribute-style Metric (`metrics.box.map50`, ...)."""

    def __init__(self, names: Dict[int, str]):
        self.names = names
        self.stats: List = []
        self.nc = len(names)
        self.box = None  # Metric, filled by compute()

    def process(self, tp, conf, pred_cls, target_cls):
        """Reference DetMetrics.process: one-shot aggregation from full
        arrays (reference metrics.py:864)."""
        self.update(np.asarray(tp), np.asarray(conf), np.asarray(pred_cls), np.asarray(target_cls))
        return self.compute()

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)"]

    def mean_results(self):
        return self.box.mean_results() if self.box else [0.0] * 4

    def class_result(self, i):
        return self.box.class_result(i)

    @property
    def maps(self):
        return self.box.maps if self.box else np.zeros(self.nc)

    @property
    def fitness(self):
        return self.box.fitness() if self.box else 0.0

    @property
    def ap_class_index(self):
        return self.box.ap_class_index if self.box else np.array([], int)

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))

    def update(self, tp: np.ndarray, conf: np.ndarray, pred_cls: np.ndarray, target_cls: np.ndarray):
        self.stats.append((tp, conf, pred_cls, target_cls))

    def compute(self) -> Dict[str, float]:
        self.result = None  # raw ap_per_class output (curves, per-class)
        self.per_class = {}
        self.box = Metric()
        self.box.nc = self.nc
        if not self.stats:
            return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0, "fitness": 0.0}
        tp = np.concatenate([s[0] for s in self.stats], 0)
        conf = np.concatenate([s[1] for s in self.stats], 0)
        pred_cls = np.concatenate([s[2] for s in self.stats], 0)
        target_cls = np.concatenate([s[3] for s in self.stats], 0)
        if tp.shape[0] == 0 or target_cls.shape[0] == 0:
            return {"precision": 0.0, "recall": 0.0, "mAP50": 0.0, "mAP50-95": 0.0, "fitness": 0.0}
        res = ap_per_class(tp, conf, pred_cls, target_cls)
        self.result = res
        self.box.from_res(res, self.nc)
        for ci, c in enumerate(res["unique_classes"]):
            self.per_class[self.names.get(int(c), str(int(c)))] = {
                "n": int(res["nt"][ci]),
                "precision": float(res["p"][ci]),
                "recall": float(res["r"][ci]),
                "mAP50": float(res["ap"][ci, 0]),
                "mAP50-95": float(res["ap"][ci].mean()),
            }
        ap50 = res["ap"][:, 0].mean() if len(res["ap"]) else 0.0
        ap = res["ap"].mean() if len(res["ap"]) else 0.0
        out = {
            "precision": float(res["p"].mean()),
            "recall": float(res["r"].mean()),
            "mAP50": float(ap50),
            "mAP50-95": float(ap),
        }
        out["fitness"] = 0.1 * out["mAP50"] + 0.9 * out["mAP50-95"]
        return out


class Metric:
    """Attribute-style per-task metric bundle (reference metrics.py:662-833)."""

    def __init__(self):
        self.p: np.ndarray = np.array([])
        self.r: np.ndarray = np.array([])
        self.f1: np.ndarray = np.array([])
        self.all_ap: np.ndarray = np.zeros((0, 10))
        self.ap_class_index: np.ndarray = np.array([], int)
        self.nc = 0
        self.nt_per_class: np.ndarray = np.array([], int)
        self.curves_data: list = []

    @property
    def ap50(self):
        return self.all_ap[:, 0] if len(self.all_ap) else []

    @property
    def ap(self):
        return self.all_ap.mean(1) if len(self.all_ap) else []

    @property
    def mp(self):
        return float(self.p.mean()) if len(self.p) else 0.0

    @property
    def mr(self):
        return float(self.r.mean()) if len(self.r) else 0.0

    @property
    def map50(self):
        return float(self.all_ap[:, 0].mean()) if len(self.all_ap) else 0.0

    @property
    def map75(self):
        return float(self.all_ap[:, 5].mean()) if len(self.all_ap) else 0.0

    @property
    def map(self):
        return float(self.all_ap.mean()) if len(self.all_ap) else 0.0

    def mean_results(self):
        return [self.mp, self.mr, self.map50, self.map]

    def class_result(self, i: int):
        return self.p[i], self.r[i], self.ap50[i], self.ap[i]

    @property
    def maps(self):
        m = np.zeros(self.nc) + self.map
        for i, c in enumerate(self.ap_class_index):
            m[int(c)] = self.ap[i]
        return m

    def fitness(self):
        w = [0.0, 0.0, 0.1, 0.9]  # [P, R, mAP@0.5, mAP@0.5:0.95] (reference :786)
        return float((np.array(self.mean_results()) * w).sum())

    def update(self, results):
        """results = (p, r, f1, all_ap, ap_class_index, p_curve, r_curve,
        f1_curve, px, prec_values) — the reference 10-tuple (:789)."""
        (self.p, self.r, self.f1, self.all_ap, self.ap_class_index,
         *self.curves_data) = results

    @property
    def curves(self):
        return [
            "Precision-Recall(B)", "F1-Confidence(B)",
            "Precision-Confidence(B)", "Recall-Confidence(B)",
        ]

    @property
    def curves_results(self):
        return self.curves_data

    def from_res(self, res: Dict, nc: int):
        """Fill from this module's ap_per_class output dict."""
        self.nc = nc
        if res is None:
            return self
        x = np.linspace(0, 1, 1000)
        self.update((
            res["p"], res["r"], res["f1"], res["ap"], res["unique_classes"],
            res["p_conf_curve"], res["r_conf_curve"], res["f1_curve"], x, res["p_curve"],
        ))
        self.nt_per_class = res["nt"]
        return self



class ValMetrics(dict):
    """What YOLO.val() returns: the metrics dict (plain keys and their
    `metrics/...(B)` aliases) with the reference's attribute surface:
    `metrics.box.map50`, `metrics.fitness`, `metrics.results_dict`."""

    box: "Metric" = None

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    @property
    def results_dict(self):
        return {k: v for k, v in self.items() if k.startswith("metrics/") or k == "fitness"}

    def mean_results(self):
        return self.box.mean_results() if self.box is not None else []

    @property
    def maps(self):
        return self.box.maps if self.box is not None else np.array([])

    @property
    def ap_class_index(self):
        return self.box.ap_class_index if self.box is not None else np.array([], int)
