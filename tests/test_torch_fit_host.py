"""The rest of the port's host side of YOLO.train and YOLO.val against the JAX
package: the image cache, packaged dataset descriptors and the settings
file, TIFF and WebP image sizes, multi_scale, the confusion matrix and
predictions.json, the logger integrations (the hosted ones on stubs of
their packages), and a tiny YOLO.train on the host
augmentation stack with plots, save_json, multi_scale and a callback that
records every event (yolov8n-cbam-swin at 64 px, 2 epochs of 2 micro-steps,
plain versions of the kernels; every host-only transform setting on,
copy_paste too, which detect ignores as the JAX package does).

The events are held to the JAX package's order, written out in
`jax_events` from its engine/trainer.py (setup :619 and :693, train :767,
:785, :808, :847, :851, :881, validate :905 and :913) and
engine/validator.py (:51 and :61). TensorBoard is switched off in the
port's settings here: where TensorFlow is installed, importing
torch.utils.tensorboard imports it (seconds); add_tensorboard is held on a
stub module. The figures are expected where matplotlib imports, the batch
grids where cv2 does.
"""

import importlib.util
import json
import sys
import types

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.utils import coco_json as JC
from improving_yolov8_cbam_swinblock_tpu.utils import metrics as JM
from improving_yolov8_cbam_swinblock_tpu.utils import settings as JS
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.ops.augment_device import scale_content
from improving_yolov8_cbam_swinblock_tpu_torch.utils import coco_json as PC
from improving_yolov8_cbam_swinblock_tpu_torch.utils import integrations as PI
from improving_yolov8_cbam_swinblock_tpu_torch.utils import metrics as PM
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.callbacks import EVENTS, NEVER_FIRED
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import image_size
from tests.synth_data import make_synth_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = "yolov8n-cbam-swin.yaml"
HOST = {"epochs": 2, "batch": 2, "nbs": 4, "imgsz": 64, "optimizer": "SGD", "close_mosaic": 1, "workers": 2,
        "max_gt": 16, "verbose": False, "device": "cpu", "device_augment": False, "mosaic9": 0.5, "mixup": 0.5,
        "mosaic3": 0.5, "copy_paste": 0.5, "degrees": 10.0, "shear": 2.0, "perspective": 5e-4, "flipud": 0.5,
        "multi_scale": True, "cache": "ram", "plots": True, "save_json": True}
HAVE = {m: importlib.util.find_spec(m) is not None for m in ("cv2", "matplotlib")}
TRAIN_AND_VAL_EVENTS = [e for e in EVENTS if e not in NEVER_FIRED and not e.startswith(("on_predict", "on_export"))]


@pytest.fixture(autouse=True, scope="module")
def no_tensorboard():
    old = PS.SETTINGS["tensorboard"]
    PS.SETTINGS["tensorboard"] = False
    yield
    PS.SETTINGS["tensorboard"] = old


def jax_events(epochs, batches, val_batches):
    """The events the JAX trainer fires for YOLO.train, in order."""
    val = ["on_val_start"] + ["on_val_batch_start", "on_val_batch_end"] * val_batches + ["on_val_end"]
    epoch = (["on_train_epoch_start"] + ["on_train_batch_end"] * batches + val
             + ["on_model_save", "on_fit_epoch_end"])
    return ["on_pretrain_routine_start", "on_pretrain_routine_end", "on_train_start"] + epoch * epochs + [
        "on_train_end"]


@pytest.fixture(scope="module")
def host_fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("host_fit")
    data = str(make_synth_dataset(root / "data", n_train=4, n_val=4, imgsz=64, nc=1, seed=7))
    y = YOLO(CFG, device="cpu")
    events = []
    for e in TRAIN_AND_VAL_EVENTS:
        y.add_callback(e, lambda obj, e=e: events.append((e, type(obj).__name__)))
    metrics = y.train(data=data, project=str(root / "runs"), **HOST)
    return {"root": root, "data": data, "y": y, "tr": y.trainer, "events": events, "metrics": metrics}


def test_host_train_fires_jax_events_and_writes_the_run(host_fit):
    tr = host_fit["tr"]
    assert [e for e, _ in host_fit["events"]] == jax_events(2, 2, 2)
    assert {o for _, o in host_fit["events"]} == {"DetectionTrainer"}
    assert tr.train_loader.hyp["mosaic"] == 0.0 and not tr.train_loader.device_augment
    files = {p.name for p in tr.save_dir.iterdir()}
    assert {"results.csv", "metrics.jsonl", "weights"} <= files
    assert ({"train_batch0.jpg", "train_batch1.jpg"} <= files) == HAVE["cv2"]
    assert ({"labels.jpg", "results.png"} <= files) == HAVE["matplotlib"]
    rows = [json.loads(line) for line in (tr.save_dir / "metrics.jsonl").read_text().splitlines()]
    assert rows == json.loads(json.dumps(tr.metrics_rows))
    assert tr.integrations == {"tensorboard": False, "jsonl": True, "wandb": False, "mlflow": False,
                               "comet": False, "clearml": False, "dvc": False, "neptune": False}
    val_dir = host_fit["root"] / "runs" / "val"
    assert ({p.name for p in val_dir.iterdir()} >= {"confusion_matrix.png", "PR_curve.png", "P_curve.png",
                                                    "R_curve.png", "F1_curve.png"}) == HAVE["matplotlib"]
    assert all(np.isfinite(r["train/box_loss"]) for r in tr.metrics_rows)


def test_host_train_batches_and_the_ram_cache(host_fit):
    """The host path's batches carry no `aug`, their boxes lie in [0, 1]; the
    RAM cache holds every train image after the first epoch."""
    tr = host_fit["tr"]
    assert len(tr.train_loader.ds._ram) == len(tr.train_loader.ds)
    tr.train_loader.set_epoch(0)
    for batch in tr.train_loader:
        assert "aug" not in batch
        m = batch["mask"] > 0
        assert np.isfinite(batch["bboxes"]).all() and (batch["bboxes"][m] >= 0).all() and (
            batch["bboxes"][m] <= 1).all()


def test_val_with_plots_and_save_json_fires_val_batch_events(host_fit):
    y = host_fit["y"]
    seen = []
    y.add_callback("on_val_batch_end", lambda v: seen.append(type(v).__name__))
    out = host_fit["root"] / "val_out"
    y.val(data=host_fit["data"], batch=2, imgsz=64, verbose=False, plots=True, save_json=True, project=str(out),
          name="v", conf=0.001)
    v = y.validator
    assert seen == ["DetectionValidator"] * 2
    kept = sum(len(s[1]) for s in v.metrics.stats)
    records = json.loads((out / "v" / "predictions.json").read_text()) if kept else []
    assert len(records) == kept and v.json_path == (str(out / "v" / "predictions.json") if kept else None)
    assert int(v.confusion_matrix.matrix[:, :-1].sum()) == sum(len(s[3]) for s in v.metrics.stats)
    y.clear_callback("on_val_batch_end")


@pytest.mark.parametrize("cache", ["ram", "disk", True])
def test_image_cache_gives_the_same_batches(tmp_path, cache):
    make_synth_dataset(tmp_path, n_train=4, n_val=1, imgsz=64, nc=2, seed=3)
    img_dir = str(tmp_path / "images" / "train")
    hyp = {"mixup": 0.5, "degrees": 5.0}

    def batches(c):
        dl = PD.DataLoader(PD.YOLODataset(img_dir, imgsz=64, max_gt=8, nc=2, cache=c), 2, train=True, hyp=hyp,
                           workers=2, device_augment=False)
        out = []
        for epoch in (0, 1):
            dl.set_epoch(epoch)
            out += list(dl)
        return out

    ref = batches(False)
    for got, want in zip(batches(cache), ref):
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    npys = sorted((tmp_path / "images" / "train").glob("*.npy"))
    assert len(npys) == (4 if cache == "disk" else 0)
    if cache == "disk":  # the JAX package reads the port's .npy files, and the other way round
        jds = JD.YOLODataset(img_dir, imgsz=64, max_gt=8, nc=2, cache="disk")
        pds = PD.YOLODataset(img_dir, imgsz=64, max_gt=8, nc=2, cache="disk")
        for i in range(4):
            assert np.array_equal(jds._read_image(i), np.load(npys[i]))
        np.save(npys[0], np.zeros((64, 64, 3), np.uint8))
        assert not pds._read_image(0).any()
    with pytest.raises(ValueError, match="must be True"):
        PD.YOLODataset(img_dir, imgsz=64, nc=2, cache="gpu")


def test_packaged_descriptors_resolve_as_jax(tmp_path, monkeypatch):
    """A bare descriptor name under one datasets_dir: the same dict as the JAX
    package's; its images absent, both raise FileNotFoundError naming the directory."""
    for s in (JS.SETTINGS, PS.SETTINGS):
        monkeypatch.setitem(s, "datasets_dir", str(tmp_path / "datasets"))
    for name in ("coco8.yaml", "coco128.yaml", "Objects365.yaml", "xView.yaml"):
        got, ref = PD.check_det_dataset(name), JD.check_det_dataset(name)
        assert {k: v for k, v in got.items() if k != "yaml_file"} == {k: v for k, v in ref.items() if k != "yaml_file"}
        assert got["train"].startswith(str(tmp_path / "datasets"))
    for mod in (PD, JD):  # a list of train splits (VOC, GlobalWheat2020) is not resolved by either package
        with pytest.raises(TypeError):
            mod.check_det_dataset("VOC.yaml")
    info = PD.check_det_dataset("coco8.yaml")
    for mod in (PD, JD):
        with pytest.raises(FileNotFoundError, match="coco8"):
            mod.YOLODataset(info["val"], imgsz=64, nc=80)
    packaged = {p.name for p in PD.DATASETS_DIR.glob("*.yaml")}
    assert packaged == {f"{n}.yaml" for n in (
        "Argoverse", "GlobalWheat2020", "Objects365", "SKU-110K", "VOC", "VisDrone", "african-wildlife",
        "brain-tumor", "coco", "coco128", "coco8", "lvis", "medical-pills", "open-images-v7", "signature", "xView",
        "coco8-seg", "coco128-seg", "carparts-seg", "crack-seg", "package-seg", "coco8-pose", "coco-pose",
        "tiger-pose", "hand-keypoints", "dog-pose", "DOTAv1", "DOTAv1.5", "dota8")}
    for n in packaged - {"coco8.yaml"}:
        assert yaml.safe_load((PD.DATASETS_DIR / n).read_text()) == yaml.safe_load(
            (JD.Path(JD.__file__).parent.parent / "cfg" / "datasets" / n).read_text())


def test_settings_file_under_xdg_config_home(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CONFIG_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    s = PS.SettingsManager()
    assert s.file == tmp_path / "improving_yolov8_cbam_swinblock_tpu_torch" / "settings.json"
    assert s["datasets_dir"] == str(tmp_path / "datasets")
    assert set(s) == {"settings_version", "datasets_dir", "tensorboard", "hosted_loggers", "clip_npz"}
    j = JS.SettingsManager()
    assert {k: s[k] for k in ("settings_version", "datasets_dir", "tensorboard", "clip_npz")} == {
        k: j[k] for k in ("settings_version", "datasets_dir", "tensorboard", "clip_npz")}
    assert s["hosted_loggers"] is False
    s.update(datasets_dir="/data").save()
    assert PS.SettingsManager()["datasets_dir"] == "/data"
    s.file.write_text(json.dumps({"datasets_dir": "/d2", "unknown": 1}))  # schema drift: known keys kept
    t = PS.SettingsManager()
    assert t["datasets_dir"] == "/d2" and "unknown" not in t and t["tensorboard"] is True
    assert t.reset()["datasets_dir"] == str(tmp_path / "datasets")


@pytest.mark.parametrize("fmt,kw", [("tif", {}), ("tiff", {"compression": "tiff_lzw"}), ("webp", {"lossless": True}),
                                    ("webp", {"quality": 80}), ("webp", {"exif": b"Exif\x00\x00"})])
def test_image_size_reads_tiff_and_webp_as_pil(tmp_path, fmt, kw):
    img = np.random.default_rng(2).integers(0, 256, (29, 71, 3), dtype=np.uint8)
    f = tmp_path / f"x.{fmt}"
    Image.fromarray(img).save(f, **kw)
    with Image.open(f) as im:
        assert image_size(f) == (*im.size, im.format.lower())


@pytest.mark.parametrize("k", [0.5, 0.71, 1.0, 1.37])
def test_multi_scale_matches_jax(k):
    """The JAX train step's multi_scale (engine/trainer.py:423-450) with k injected."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = rng.random((2, 64, 64, 3)).astype(np.float32)
    bb = np.concatenate([rng.uniform(0.02, 0.98, (2, 6, 2)), rng.uniform(0.005, 0.6, (2, 6, 2))], -1).astype(np.float32)
    mask = (rng.random((2, 6)) < 0.8).astype(np.float32)
    kj = jnp.float32(k)
    xs = jax.image.scale_and_translate(jnp.asarray(x), x.shape, (1, 2), jnp.stack([kj, kj]),
                                       jnp.full((2,), (1 - kj) * 64 / 2), method="linear", antialias=False)
    ctr, wh = (bb[..., :2] - 0.5) * kj + 0.5, bb[..., 2:4] * kj
    lt, rb = jnp.clip(ctr - wh / 2, 0.0, 1.0), jnp.clip(ctr + wh / 2, 0.0, 1.0)
    ctr, wh = (lt + rb) / 2, rb - lt
    new_mask = mask * (((ctr > 0.0) & (ctr < 1.0)).all(-1) & (wh > 1e-3).all(-1))
    x_p, b_p, m_p = scale_content(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(bb),
                                  torch.from_numpy(mask), torch.tensor(k))
    np.testing.assert_allclose(x_p.permute(0, 2, 3, 1).numpy(), np.asarray(jax.device_get(xs)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(m_p.numpy(), np.asarray(new_mask))
    np.testing.assert_allclose(b_p.numpy(), np.asarray(jnp.concatenate([ctr, wh], -1) * new_mask[..., None]),
                               rtol=0, atol=1e-7)


def detections(seed, nc=3):
    rng = np.random.default_rng(seed)
    gt_xy = rng.uniform(0, 50, (5, 2))
    gt = np.concatenate([gt_xy, gt_xy + rng.uniform(5, 20, (5, 2))], 1).astype(np.float32)
    det = np.concatenate([gt + rng.normal(0, 2, gt.shape), rng.uniform(0.1, 1, (5, 1)),
                          rng.integers(0, nc, (5, 1))], 1).astype(np.float32)
    extra = np.array([[60, 60, 70, 70, 0.9, 1], [0, 0, 3, 3, 0.2, 0]], np.float32)
    return np.concatenate([det, extra]), gt, rng.integers(0, nc, 5)


def test_confusion_matrix_and_predictions_json_match_jax(tmp_path):
    cm_p, cm_j = PM.ConfusionMatrix(3), JM.ConfusionMatrix(3)
    per_image = []
    for seed in range(6):
        det, gt, gt_cls = detections(seed)
        if seed == 4:
            det = det[:0]
        if seed == 5:
            gt, gt_cls = gt[:0], gt_cls[:0]
        cm_p.process_batch(det, gt, gt_cls)
        cm_j.process_batch(det, gt, gt_cls)
        if len(det):
            per_image.append({"image_id": seed, "boxes": det[:, :6]})
    np.testing.assert_array_equal(cm_p.matrix, cm_j.matrix)
    p = PC.detections_to_coco_json(per_image, str(tmp_path / "p.json"))
    j = JC.detections_to_coco_json(per_image, str(tmp_path / "j.json"))
    assert open(p, "rb").read() == open(j, "rb").read()
    assert cm_p.plot(str(tmp_path / "cm.png"), {0: "a", 1: "b", 2: "c"}) == (
        str(tmp_path / "cm.png") if HAVE["matplotlib"] else None)


def test_integrations(tmp_path, monkeypatch):
    """metrics.jsonl takes a row per epoch; TensorBoard writes through
    torch.utils.tensorboard's SummaryWriter (a stub here); a hosted logger
    whose package does not import registers nothing."""
    written = []

    class Writer:
        def __init__(self, log_dir):
            written.append(("dir", log_dir))

        def add_scalar(self, k, v, step):
            written.append((k, v, step))

        def flush(self):
            pass

        def close(self):
            written.append("closed")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", types.SimpleNamespace(SummaryWriter=Writer))
    monkeypatch.setitem(sys.modules, "wandb", None)
    cb = {e: [] for e in EVENTS}
    assert PI.add_tensorboard(cb, str(tmp_path / "tb")) and PI.add_jsonl(cb, str(tmp_path / "m.jsonl"))
    assert not PI.add_wandb(cb, "p", "n")
    tr = types.SimpleNamespace(metrics_rows=[])
    for epoch in range(2):
        tr.metrics_rows.append({"epoch": epoch, "train/box_loss": 1.5 - epoch, "metrics/mAP50": 0.25 * epoch})
        for fn in cb["on_fit_epoch_end"]:
            fn(tr)
    for fn in cb["on_train_end"]:
        fn(tr)
    assert [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()] == tr.metrics_rows
    assert written == [("dir", str(tmp_path / "tb")), ("train/box_loss", 1.5, 0), ("metrics/mAP50", 0.0, 0),
                       ("train/box_loss", 0.5, 1), ("metrics/mAP50", 0.25, 1), "closed"]


class Recorder:
    """A stand-in for a logger's package: every attribute, item and call is
    another Recorder named by its path, and every call is appended to `log`
    as (path, args, kwargs), with a Recorder among the args given by its path."""

    def __init__(self, log, name):
        self._log, self._name = log, name

    def __getattr__(self, attr):
        return Recorder(self._log, f"{self._name}.{attr}")

    def __getitem__(self, key):
        return Recorder(self._log, f"{self._name}[{key}]")

    def __call__(self, *args, **kwargs):
        self._log.append((self._name, tuple(str(a) if isinstance(a, Recorder) else a for a in args), kwargs))
        return Recorder(self._log, f"{self._name}()")

    def __str__(self):
        return self._name


# the hosted loggers: the module each imports, and the calls a run of 2 epochs makes on it
# (rows {box 1.5, mAP50 0.0} and {box 0.5, mAP50 0.25}; best.pt and results.csv exist)
HOSTED = {
    "wandb": ("wandb", lambda d: [
        ("wandb.init", (), {"project": "runs", "name": "train", "resume": "allow"}),
        ("wandb.init().log", ({"train/box_loss": 1.5, "metrics/mAP50": 0.0},), {"step": 0}),
        ("wandb.init().log", ({"train/box_loss": 0.5, "metrics/mAP50": 0.25},), {"step": 1}),
        ("wandb.Artifact", ("run_wandb.init().id_model",), {"type": "model"}),
        ("wandb.Artifact().add_file", (str(d / "w" / "best.pt"),), {}),
        ("wandb.init().log_artifact", ("wandb.Artifact()",), {"aliases": ["best"]}),
        ("wandb.init().finish", (), {})]),
    "mlflow": ("mlflow", lambda d: [
        ("mlflow.set_experiment", ("runs",), {}), ("mlflow.start_run", (), {"run_name": "train"}),
        ("mlflow.log_params", ({"lr0": "0.01"},), {}),
        ("mlflow.log_metrics", ({"train/box_loss": 1.5, "metrics/mAP50": 0.0},), {"step": 0}),
        ("mlflow.log_metrics", ({"train/box_loss": 0.5, "metrics/mAP50": 0.25},), {"step": 1}),
        ("mlflow.log_artifact", (str(d / "w" / "best.pt"),), {}),
        ("mlflow.log_artifact", (str(d / "results.csv"),), {}), ("mlflow.end_run", (), {})]),
    "comet": ("comet_ml", lambda d: [
        ("comet_ml.Experiment", (), {"project_name": "runs"}),
        ("comet_ml.Experiment().log_metrics", ({"train/box_loss": 1.5, "metrics/mAP50": 0.0},), {"epoch": 0}),
        ("comet_ml.Experiment().log_metrics", ({"train/box_loss": 0.5, "metrics/mAP50": 0.25},), {"epoch": 1}),
        ("comet_ml.Experiment().log_model", ("best", str(d / "w" / "best.pt")), {}),
        ("comet_ml.Experiment().end", (), {})]),
    "clearml": ("clearml", lambda d: [
        ("clearml.Task.init", (), {"project_name": "runs", "task_name": "train"})] + [
        ("clearml.Task.init().get_logger", (), {}) if i % 2 == 0 else
        ("clearml.Task.init().get_logger().report_scalar", ("train", k, v), {"iteration": e})
        for e, row in enumerate(({"train/box_loss": 1.5, "metrics/mAP50": 0.0},
                                 {"train/box_loss": 0.5, "metrics/mAP50": 0.25}))
        for k, v in row.items() for i in range(2)]),
    "dvc": ("dvclive", lambda d: [
        ("dvclive.Live", (), {"save_dvc_exp": True}),
        ("dvclive.Live().log_metric", ("train/box_loss", 1.5), {}), ("dvclive.Live().log_metric", ("metrics/mAP50", 0.0), {}),
        ("dvclive.Live().next_step", (), {}),
        ("dvclive.Live().log_metric", ("train/box_loss", 0.5), {}), ("dvclive.Live().log_metric", ("metrics/mAP50", 0.25), {}),
        ("dvclive.Live().next_step", (), {}), ("dvclive.Live().end", (), {})]),
    "neptune": ("neptune", lambda d: [
        ("neptune.init_run", (), {"project": "runs", "name": "train"}),
        ("neptune.init_run()[train/train/box_loss].append", (1.5,), {"step": 0}),
        ("neptune.init_run()[train/metrics/mAP50].append", (0.0,), {"step": 0}),
        ("neptune.init_run()[train/train/box_loss].append", (0.5,), {"step": 1}),
        ("neptune.init_run()[train/metrics/mAP50].append", (0.25,), {"step": 1})]),
}


@pytest.mark.parametrize("logger", list(HOSTED))
def test_hosted_logger_registers_only_with_hosted_loggers_on(logger, tmp_path, monkeypatch):
    """Each hosted logger on a stub of its package: with
    SETTINGS["hosted_loggers"] off (the default) nothing is called, since
    its init would reach a server; on, it registers and logs each epoch's
    scalars and, at the end, best.pt where it uploads files."""
    log = []
    for name, (module, _) in HOSTED.items():
        monkeypatch.setitem(sys.modules, module, Recorder(log, module) if name == logger else None)
    (tmp_path / "w").mkdir()
    for f in (tmp_path / "w" / "best.pt", tmp_path / "results.csv"):
        f.write_text("x")
    trainer = types.SimpleNamespace(callbacks={e: [] for e in EVENTS}, args=types.SimpleNamespace(lr0=0.01),
                                    save_dir=tmp_path, wdir=tmp_path / "w", metrics_rows=[])
    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    monkeypatch.setitem(PS.SETTINGS, "hosted_loggers", False)
    assert not any(v for k, v in PI.add_integration_callbacks(trainer).items() if k != "jsonl") and not log
    trainer.callbacks = {e: [] for e in EVENTS}
    monkeypatch.setitem(PS.SETTINGS, "hosted_loggers", True)
    got = PI.add_integration_callbacks(trainer)
    assert got == {k: k in ("jsonl", logger) for k in ("tensorboard", "jsonl", *HOSTED)}
    for fn in trainer.callbacks["on_pretrain_routine_end"]:
        fn(trainer)
    for epoch in range(2):
        trainer.metrics_rows.append({"epoch": epoch, "train/box_loss": 1.5 - epoch, "metrics/mAP50": 0.25 * epoch})
        for fn in trainer.callbacks["on_fit_epoch_end"]:
            fn(trainer)
    for fn in trainer.callbacks["on_train_end"]:
        fn(trainer)
    assert log == HOSTED[logger][1](tmp_path)


@pytest.mark.parametrize("event", TRAIN_AND_VAL_EVENTS)
def test_add_callback_takes_the_fired_train_and_val_events(event):
    y = YOLO(CFG, device="cpu")
    y.add_callback(event, print)
    assert y.callbacks[event] == [print]
