"""The port's validation vs the JAX package's: the host metrics tail,
multi-label NMS, and YOLO.val end to end.

The metrics are a numpy copy, so match_predictions, ap_per_class (curves
included) and DetMetrics equal JAX's to 1e-12 on seeded arrays with ties in
conf and IoU. Multi-label NMS equals JAX's non_max_suppression(multi_label=
True) exactly, equal scores included (the lower flat index first).

YOLO.val: yolov8n-cbam-swin at 96 px, fp32, on make_valparity_dataset (8
PNGs of 96 px: the letterbox is the identity on both sides), the JAX
model's seeded variables carried into the port (one JAX compile, the
validator's forward + NMS). (a) JAX's per-image detections fed into the
port's matching and AP tail give JAX's metrics exactly. (b) End to end,
each metric within 1e-3, and each image's detections as test_torch_predict
holds predict's: the same count, and the rows sorted by conf within rtol
2e-3, atol 2e-2 (the same fp32 graph summed in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.ops.nms import non_max_suppression as jax_nms
from improving_yolov8_cbam_swinblock_tpu.utils import metrics as JM
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import MAX_NMS, non_max_suppression
from improving_yolov8_cbam_swinblock_tpu_torch.utils import metrics as PM
from tests.synth_data import make_valparity_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_model import seeded_variables
from tests.test_torch_predict import random_prediction

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
KEYS = ("precision", "recall", "mAP50", "mAP50-95", "fitness")


def seeded_stats(rng, n_img=6, nc=3):
    """Per image: (tp, conf, pred_cls, target_cls) from match_predictions on
    IoUs rounded to 0.05 and confs rounded to 0.1 (many ties); one image
    without predictions."""
    out = []
    for i in range(n_img):
        n_gt, n_pred = int(rng.integers(1, 6)), (0 if i == 2 else int(rng.integers(1, 12)))
        gt_cls, pred_cls = rng.integers(0, nc, n_gt), rng.integers(0, nc, n_pred)
        iou = np.round(rng.uniform(0, 1, (n_gt, n_pred)) * 20) / 20
        tp = PM.match_predictions(pred_cls, gt_cls, iou)
        np.testing.assert_array_equal(tp, JM.match_predictions(pred_cls, gt_cls, iou))
        out.append((tp, np.round(rng.uniform(0, 1, n_pred), 1), pred_cls, gt_cls))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_tail_matches_jax(seed):
    stats = seeded_stats(np.random.default_rng(seed))
    cat = [np.concatenate([s[k] for s in stats]) for k in range(4)]
    got, ref = PM.ap_per_class(*cat), JM.ap_per_class(*cat)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-12, err_msg=k)
    names = {0: "a", 1: "b", 2: "c"}
    pm, jm = PM.DetMetrics(names), JM.DetMetrics(names)
    for s in stats:
        pm.update(*s)
        jm.update(*s)
    out, out_ref = pm.compute(), jm.compute()
    assert out.keys() == out_ref.keys()
    np.testing.assert_allclose([out[k] for k in out], [out_ref[k] for k in out], rtol=0, atol=1e-12)
    assert pm.per_class == jm.per_class
    np.testing.assert_allclose(pm.box.mean_results(), jm.box.mean_results(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pm.maps, jm.maps, rtol=0, atol=1e-12)
    assert pm.fitness == pytest.approx(jm.fitness, abs=1e-12) and pm.results_dict.keys() == jm.results_dict.keys()


@pytest.mark.parametrize("nc,ties,a", [(3, True, 300), (3, False, 300), (2, True, MAX_NMS // 2 + 300)])
def test_multi_label_nms_matches_jax(nc, ties, a):
    """The last case has more (anchor, class) pairs than MAX_NMS."""
    pred = random_prediction(np.random.default_rng(nc * 10 + ties), 3, nc, a, ties)
    kw = dict(conf_thres=0.3, iou_thres=0.5, max_det=50, nc=nc, multi_label=True)
    ref = np.asarray(jax_nms(jnp.asarray(pred), max_nms=MAX_NMS, **kw))
    out = non_max_suppression(torch.from_numpy(pred), **kw).numpy()
    np.testing.assert_array_equal(out, ref)
    assert len(np.unique(out[..., 5])) > 1


@pytest.fixture(scope="module")
def val_run(tmp_path_factory):
    """JAX YOLO.val and the port's on the same images and weights, plus the
    JAX validator's batches and per-image detections."""
    root = tmp_path_factory.mktemp("valparity")
    data = str(make_valparity_dataset(root, nc=1, imgsz=96, n=8))
    jy = JaxYOLO(CFG)
    jy.variables = seeded_variables(jy.model, 96, np.random.default_rng(0))
    made = []
    init = JV.DetectionValidator.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    JV.DetectionValidator.__init__ = keep
    try:
        ref = jy.val(data=data, imgsz=96, batch=4, verbose=False, plots=False, project=str(root / "runs"))
    finally:
        JV.DetectionValidator.__init__ = init
    batches = list(made[0].loader)
    jdets = [np.asarray(made[0]._forward_nms(jy.variables, jnp.asarray(b["img"]))) for b in batches]
    py = YOLO(CFG, device="cpu").load_jax_variables(jy.variables)
    got = py.val(data=data, imgsz=96, batch=4, verbose=False)
    return {"ref": ref, "got": got, "batches": batches, "jdets": jdets, "py": py}


def test_val_tail_on_jax_detections_matches_jax_exactly(val_run):
    py = val_run["py"]
    v = DetectionValidator(py.model, None, py.validator.args)
    for b, d in zip(val_run["batches"], val_run["jdets"]):
        v.update_metrics(d, b)
    out = v.metrics.compute()
    assert {k: out[k] for k in KEYS} == {k: val_run["ref"][k] for k in KEYS}
    assert sum(len(d[d[:, 4] > 0]) for d in np.concatenate(val_run["jdets"])) > 0


def test_val_matches_jax_end_to_end(val_run):
    got, ref, py = val_run["got"], val_run["ref"], val_run["py"]
    for k in KEYS:
        assert got[k] == pytest.approx(ref[k], abs=1e-3), k
    assert {k: got[k] for k in ref} == pytest.approx(dict(ref), abs=1e-3)
    assert got.box.map50 == got["mAP50"] and got.box.map == got["mAP50-95"]
    assert got.results_dict["metrics/mAP50(B)"] == got["mAP50"] and got.fitness == got["fitness"]
    assert py.validator.seen == 8
    for b, jd in zip(val_run["batches"], val_run["jdets"]):
        pd = py.validator.forward_nms(b["img"])
        for r, rr in zip(pd, jd):
            r, rr = r[r[:, 4] > 0], rr[rr[:, 4] > 0]
            assert len(r) == len(rr)
            o, oo = np.argsort(-r[:, 4], kind="stable"), np.argsort(-rr[:, 4], kind="stable")
            np.testing.assert_allclose(r[o], rr[oo], rtol=2e-3, atol=2e-2)
