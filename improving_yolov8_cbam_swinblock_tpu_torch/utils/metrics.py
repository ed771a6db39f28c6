"""Detection metrics: IoU matching over 10 thresholds, per-class AP (101-point
interpolation), DetMetrics, Metric and ValMetrics, the confusion matrix and
the PR, P, R and F1 curves (a copy of the JAX package's
utils/metrics.py:16-275, 375-460, 459-547 and 703; numpy on the host, as
there). matplotlib is imported where a figure is drawn, and a plot returns
None (plot_pr_curves an empty list) without it. The segment task's
mask_iou_np and SegmentMetrics, and the pose task's OKS_SIGMA, kpt_iou_np
and PoseMetrics, are here too; the OBB metrics are not in the port.
"""

from __future__ import annotations

from pathlib import Path
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


def mask_iou_np(mask1: np.ndarray, mask2: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """(N, HW) and (M, HW) binary masks -> (N, M) IoU, the intersections as an fp32 product."""
    inter = mask1.astype(np.float32) @ mask2.astype(np.float32).T
    union = mask1.sum(1)[:, None] + mask2.sum(1)[None] - inter
    return inter / (union + eps)


# the COCO 17-keypoint OKS sigmas
OKS_SIGMA = np.array([0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07, 1.07, 0.87, 0.87,
                      0.89, 0.89]) / 10.0


def kpt_iou_np(kpt1: np.ndarray, kpt2: np.ndarray, area: np.ndarray, sigma: np.ndarray,
               eps: float = 1e-7) -> np.ndarray:
    """Object keypoint similarity (N, M) of GT keypoints (N, K, 3) (a point
    counts where its visibility is not 0) and predicted (M, K, 2 or 3), with
    each GT's area (N,): the mean over the GT's visible points of
    exp(-d^2 / (2 sigma)^2 / (area + eps) / 2)."""
    d = (kpt1[:, None, :, 0] - kpt2[None, :, :, 0]) ** 2 + (kpt1[:, None, :, 1] - kpt2[None, :, :, 1]) ** 2
    kpt_mask = kpt1[..., 2] != 0  # (N, K)
    e = d / ((2 * sigma[None, None]) ** 2) / (area[:, None, None] + eps) / 2
    return (np.exp(-e) * kpt_mask[:, None]).sum(-1) / (kpt_mask.sum(-1)[:, None] + eps)


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


class ConfusionMatrix:
    """Detection confusion matrix (JAX utils/metrics.py:159): (nc + 1, nc + 1)
    counts, rows the predicted class, columns the true one, the last row and
    column the background (missed GT, unmatched detections)."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), dtype=np.int64)

    def process_batch(self, detections: np.ndarray, gt_bboxes: np.ndarray, gt_cls: np.ndarray):
        """detections (n, 6) xyxy, conf, cls; gt_bboxes (m, 4) xyxy; gt_cls (m,)."""
        gt_cls = np.asarray(gt_cls, int)
        if detections is None or len(detections) == 0:
            for gc in gt_cls:
                self.matrix[self.nc, gc] += 1
            return
        detections = detections[detections[:, 4] > self.conf]
        det_cls = detections[:, 5].astype(int)
        if len(gt_cls) == 0:
            for dc in det_cls:
                self.matrix[dc, self.nc] += 1
            return
        iou = box_iou_np(gt_bboxes, detections[:, :4])
        x = np.argwhere(iou > self.iou_thres)
        if x.shape[0]:
            matches = np.concatenate((x, iou[x[:, 0], x[:, 1]][:, None]), 1)
            if x.shape[0] > 1:
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[matches[:, 2].argsort()[::-1]]
                matches = matches[np.unique(matches[:, 0], return_index=True)[1]]
        else:
            matches = np.zeros((0, 3))
        n = matches.shape[0] > 0
        m0, m1, _ = matches.transpose().astype(int)
        for i, gc in enumerate(gt_cls):
            j = m0 == i
            if n and j.sum() == 1:
                self.matrix[det_cls[m1[j]][0], gc] += 1  # matched: right or confused class
            else:
                self.matrix[self.nc, gc] += 1  # missed
        for i, dc in enumerate(det_cls):
            if not (n and (m1 == i).any()):
                self.matrix[dc, self.nc] += 1  # unmatched detection

    def plot(self, save_path: str, names: Dict[int, str] | None = None, normalize: bool = True):
        """The matrix as an image (columns normalised with `normalize`); None without matplotlib."""
        plt = _pyplot()
        if plt is None:
            return None
        m = self.matrix.astype(np.float64)
        if normalize:
            m = m / np.maximum(m.sum(0, keepdims=True), 1e-9)
        fig, ax = plt.subplots(figsize=(7, 6))
        im = ax.imshow(m, cmap="Blues")
        labels = [str((names or {}).get(i, i)) for i in range(self.nc)] + ["background"]
        ax.set_xticks(range(self.nc + 1), labels, rotation=90, fontsize=7)
        ax.set_yticks(range(self.nc + 1), labels, fontsize=7)
        ax.set_xlabel("True")
        ax.set_ylabel("Predicted")
        fig.colorbar(im)
        fig.tight_layout()
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path


def _pyplot():
    """matplotlib.pyplot on the Agg backend, or None where matplotlib does not import."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pr_curves(res: Dict, save_dir: str, names: Dict[int, str] | None = None) -> List[str]:
    """PR_curve.png, P_curve.png, R_curve.png and F1_curve.png from
    ap_per_class's curves (JAX utils/metrics.py:230); [] without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return []
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    x = np.linspace(0, 1, 1000)
    out = []
    curves = [
        ("PR_curve.png", res["r_curve_x"], res["p_curve"], "Recall", "Precision"),
        ("P_curve.png", x, res["p_conf_curve"], "Confidence", "Precision"),
        ("R_curve.png", x, res["r_conf_curve"], "Confidence", "Recall"),
        ("F1_curve.png", x, res["f1_curve"], "Confidence", "F1"),
    ]
    for fname, xs, ys, xl, yl in curves:
        fig, ax = plt.subplots(figsize=(6, 4))
        for ci, c in enumerate(res["unique_classes"]):
            label = str((names or {}).get(int(c), int(c)))
            ax.plot(xs if np.ndim(xs) == 1 else xs[ci], ys[ci], linewidth=1, label=label)
        ax.plot(xs if np.ndim(xs) == 1 else np.asarray(xs).mean(0), np.asarray(ys).mean(0), "b-", linewidth=2,
                label="all classes")
        ax.set_xlabel(xl)
        ax.set_ylabel(yl)
        ax.set_xlim(0, 1)
        ax.set_ylim(0, 1.02)
        if len(res["unique_classes"]) <= 20:
            ax.legend(fontsize=7)
        fig.tight_layout()
        p = save_dir / fname
        fig.savefig(p, dpi=120)
        plt.close(fig)
        out.append(str(p))
    return out


def plot_pr_curve(px, py, ap, save_dir="pr_curve.png", names=None, on_plot=None):
    """One PR figure, a line per class (JAX utils/metrics.py:405); None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    names = names or {}
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.stack(py, axis=1) if isinstance(py, list) else np.asarray(py)
    if 0 < len(names) < 21:
        for i, y in enumerate(py.T):
            ax.plot(px, y, linewidth=1, label=f"{names.get(i, i)} {ap[i, 0]:.3f}")
    else:
        ax.plot(px, py, linewidth=1, color="grey")
    ax.plot(px, py.mean(1), linewidth=3, color="blue", label=f"all classes {ap[:, 0].mean():.3f} mAP@0.5")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)
    if on_plot:
        on_plot(save_dir)
    return save_dir


def plot_mc_curve(px, py, save_dir="mc_curve.png", names=None, xlabel="Confidence", ylabel="Metric", on_plot=None):
    """A metric against confidence (JAX utils/metrics.py:431); None without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    names = names or {}
    fig, ax = plt.subplots(1, 1, figsize=(9, 6), tight_layout=True)
    py = np.asarray(py)
    if 0 < len(names) < 21:
        for i, y in enumerate(py):
            ax.plot(px, y, linewidth=1, label=f"{names.get(i, i)}")
    else:
        ax.plot(px, py.T, linewidth=1, color="grey")
    y = smooth(py.mean(0), 0.05)
    ax.plot(px, y, linewidth=3, color="blue", label=f"all classes {y.max():.2f} at {px[y.argmax()]:.3f}")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.legend(bbox_to_anchor=(1.04, 1), loc="upper left")
    fig.savefig(save_dir, dpi=250)
    plt.close(fig)
    if on_plot:
        on_plot(save_dir)
    return save_dir


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



class SegmentMetrics:
    """The box and mask Metric pair of the segment task (the JAX package's
    utils/metrics.py SegmentMetrics): fitness is the sum of both fitnesses."""

    def __init__(self, save_dir=".", plot=False, names=()):
        self.save_dir = save_dir
        self.plot = plot
        self.names = dict(names) if not isinstance(names, dict) else names
        self.box = Metric()
        self.seg = Metric()
        self.speed = {"preprocess": 0.0, "inference": 0.0, "loss": 0.0, "postprocess": 0.0}

    def process(self, tp, tp_m, conf, pred_cls, target_cls, on_plot=None):
        nc = max(len(self.names), int(np.max(target_cls, initial=0)) + 1)
        self.seg.from_res(ap_per_class(np.asarray(tp_m), conf, pred_cls, target_cls), nc)
        self.box.from_res(ap_per_class(np.asarray(tp), conf, pred_cls, target_cls), nc)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                "metrics/precision(M)", "metrics/recall(M)", "metrics/mAP50(M)", "metrics/mAP50-95(M)"]

    def mean_results(self):
        return self.box.mean_results() + self.seg.mean_results()

    def class_result(self, i):
        return self.box.class_result(i) + self.seg.class_result(i)

    @property
    def maps(self):
        return self.box.maps + self.seg.maps

    @property
    def fitness(self):
        return self.seg.fitness() + self.box.fitness()

    @property
    def ap_class_index(self):
        return self.box.ap_class_index

    @property
    def results_dict(self):
        return dict(zip(self.keys + ["fitness"], self.mean_results() + [self.fitness]))


class PoseMetrics(SegmentMetrics):
    """The box and OKS keypoint Metric pair of the pose task (the JAX
    package's utils/metrics.py PoseMetrics): fitness is the sum of both fitnesses."""

    def __init__(self, save_dir=".", plot=False, names=()):
        super().__init__(save_dir, plot, names)
        self.pose = Metric()
        del self.seg

    def process(self, tp, tp_p, conf, pred_cls, target_cls, on_plot=None):
        nc = max(len(self.names), int(np.max(target_cls, initial=0)) + 1)
        self.pose.from_res(ap_per_class(np.asarray(tp_p), conf, pred_cls, target_cls), nc)
        self.box.from_res(ap_per_class(np.asarray(tp), conf, pred_cls, target_cls), nc)

    @property
    def keys(self):
        return ["metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)", "metrics/mAP50-95(B)",
                "metrics/precision(P)", "metrics/recall(P)", "metrics/mAP50(P)", "metrics/mAP50-95(P)"]

    def mean_results(self):
        return self.box.mean_results() + self.pose.mean_results()

    def class_result(self, i):
        return self.box.class_result(i) + self.pose.class_result(i)

    @property
    def maps(self):
        return self.box.maps + self.pose.maps

    @property
    def fitness(self):
        return self.pose.fitness() + self.box.fitness()


class ValMetrics(dict):
    """What YOLO.val() returns: the metrics dict (plain keys and their
    `metrics/...(B)` aliases, or for a segmentation model the `(B)` and
    `(M)` keys, for a pose model the `(B)` and `(P)` keys) with the
    reference's attribute surface: `metrics.box.map50`, `metrics.seg.map`
    (segment), `metrics.pose.map` (pose), `metrics.fitness`,
    `metrics.results_dict`."""

    box: "Metric" = None
    seg: "Metric" = None
    pose: "Metric" = None

    def __getattr__(self, name):
        if name in self:
            return self[name]
        raise AttributeError(name)

    @property
    def results_dict(self):
        return {k: v for k, v in self.items() if k.startswith("metrics/") or k == "fitness"}

    def mean_results(self):
        return [v for m in (self.box, self.seg, self.pose) if m is not None for v in m.mean_results()]

    @property
    def maps(self):
        return self.box.maps if self.box is not None else np.array([])

    @property
    def ap_class_index(self):
        return self.box.ap_class_index if self.box is not None else np.array([], int)
