"""The port's YOLO.train and its checkpoints on the CPU (plain versions of the kernels).

yolov8n-cbam-swin at 64 px on tests/synth_data.py's dataset (4 train and 4
val images): 2 epochs of 2 micro-steps at batch 2 (nbs 4: one optimizer
step per epoch), SGD, close_mosaic 1, validation every epoch. Checked: the
run's files and results.csv, mosaic on in epoch 1 and off in epoch 2, a
fresh trainer restoring epoch 1's checkpoint bit for bit and then training
epoch 2 alone to the same weights bit for bit, YOLO(best.pt).val equal to
the metrics recorded for that epoch, and the warm start's matched and
skipped counts with another nc. TensorBoard is switched off in the port's
settings here, as in test_torch_fit_host.py (its import costs seconds).
The train step itself is held to JAX by test_torch_train.py.
"""

import csv
import copy

import pytest
import torch

from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from tests.synth_data import make_synth_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CFG = "yolov8n-cbam-swin.yaml"
FIT = {"epochs": 2, "batch": 2, "nbs": 4, "imgsz": 64, "optimizer": "SGD", "close_mosaic": 1, "workers": 2,
       "save_period": 1, "max_gt": 16, "verbose": False, "device": "cpu"}


def train_state(tr):
    return {"model": copy.deepcopy(tr.model.state_dict()), "optimizer": copy.deepcopy(tr.optimizer.state_dict()),
            "ema": copy.deepcopy(tr.ema), "scalars": (tr.ema_updates, tr.step, tr.epoch, tr.best_fitness),
            "aug_gen": tr.aug_gen.get_state()}


def assert_same_bits(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_bits(x, y, f"{where}/{i}")
    else:
        assert a == b, where


@pytest.fixture(autouse=True, scope="module")
def no_tensorboard():
    old = PS.SETTINGS["tensorboard"]
    PS.SETTINGS["tensorboard"] = False
    yield
    PS.SETTINGS["tensorboard"] = old


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    root = tmp_path_factory.mktemp("fit")
    data = str(make_synth_dataset(root / "data", n_train=4, n_val=4, imgsz=64, nc=1, seed=7))
    steps, snaps = [], {}
    mk, save = DetectionTrainer._make_train_step, DetectionTrainer.save_checkpoint

    def recorded(self, nb):
        step, acc = mk(self, nb)

        def run(batch):
            steps.append((self.epoch, float(batch["aug"][0])))
            return step(batch)
        return run, acc

    def snap(self, path):
        save(self, path)
        if path.name == "epoch0.pt":
            snaps["epoch0"] = train_state(self)

    DetectionTrainer._make_train_step, DetectionTrainer.save_checkpoint = recorded, snap
    try:
        y = YOLO(CFG, device="cpu")
        metrics = y.train(data=data, project=str(root / "runs"), **FIT)
        tr = y.trainer
        tr2 = DetectionTrainer(overrides={**FIT, "model": CFG, "data": data, "project": str(root / "runs"),
                                          "name": "resume", "resume": str(tr.wdir / "epoch0.pt")}).setup()
        tr2.load_checkpoint(tr.wdir / "epoch0.pt")
        restored = train_state(tr2)
        n = len(steps)
        tr2.train()
    finally:
        DetectionTrainer._make_train_step, DetectionTrainer.save_checkpoint = mk, save
    return {"data": data, "root": root, "y": y, "tr": tr, "tr2": tr2, "metrics": metrics, "steps": steps,
            "resumed_steps": steps[n:], "snap": snaps["epoch0"], "restored": restored}


def test_train_writes_the_run(fit):
    tr = fit["tr"]
    assert {p.name for p in tr.wdir.iterdir()} == {"last.pt", "best.pt", "epoch0.pt", "epoch1.pt"}
    with open(tr.save_dir / "results.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert set(rows[0]) == {"epoch", "time_s", "train/box_loss", "train/cls_loss", "train/dfl_loss",
                            "metrics/precision", "metrics/recall", "metrics/mAP50", "metrics/mAP50-95",
                            "metrics/fitness"}
    assert all(torch.isfinite(torch.tensor([float(r[k]) for k in r if k.startswith("train/")])).all()
               for r in rows)
    assert fit["metrics"] == {k.removeprefix("metrics/"): v for k, v in tr.metrics_rows[-1].items()
                              if k.startswith("metrics/")}
    # 2 micro-steps an epoch, mosaic closed for the last epoch
    assert fit["steps"][:4] == [(0, 1.0), (0, 1.0), (1, 0.0), (1, 0.0)]
    assert tr.step == 4 and tr.ema_updates == 2 and tr.accumulate == 2


def test_resume_restores_the_state_bit_for_bit(fit):
    assert_same_bits(fit["restored"], fit["snap"])
    tr, tr2 = fit["tr"], fit["tr2"]
    assert fit["resumed_steps"] == [(1, 0.0), (1, 0.0)]
    assert [r["epoch"] for r in tr2.metrics_rows] == [1]
    assert_same_bits(train_state(tr2), train_state(tr))


def test_best_pt_loads_and_its_val_equals_the_record(fit):
    tr = fit["tr"]
    best = YOLO(str(tr.wdir / "best.pt"), device="cpu")
    assert best.model.names == tr.model.names and best.model.dtype == tr.model.dtype
    rec = next(r for r in tr.metrics_rows if r["metrics/fitness"] == tr.best_fitness)
    vm = best.val(data=fit["data"], batch=2, imgsz=64, verbose=False)
    assert {k: vm[k] for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness")} == {
        k.removeprefix("metrics/"): v for k, v in rec.items() if k.startswith("metrics/")}
    # YOLO.train adopted best.pt's EMA weights
    assert_same_bits(fit["y"].model.state_dict(), best.model.state_dict())


def test_warm_start_with_another_nc(fit, capsys):
    data3 = str(make_synth_dataset(fit["root"] / "data3", n_train=2, n_val=2, imgsz=64, nc=3, seed=8))
    y = YOLO(str(fit["tr"].wdir / "best.pt"), device="cpu")
    y.train(data=data3, project=str(fit["root"] / "runs"), name="nc3", **{**FIT, "epochs": 1, "val": False})
    st = y.trainer.transfer_stats
    n = sum(1 for _ in y.trainer._ema_sources())
    assert st["matched"] + st["skipped"] == n and st["skipped"] == 6  # the 3 levels' class conv weight and bias
    assert f"Transferred {st['matched']}/{n}" in capsys.readouterr().out
    assert y.model.nc == 3 and not (y.trainer.wdir / "best.pt").exists()  # no val: the final EMA is adopted


def test_val_runs_a_quantized_model(fit):
    """val on an int8 model runs its int8 path and returns the metrics."""
    import numpy as np

    from improving_yolov8_cbam_swinblock_tpu_torch import quantize_model
    from improving_yolov8_cbam_swinblock_tpu_torch.ops.quant import is_quantized

    y = YOLO(CFG, device="cpu", param_dtype=torch.float32).fuse()
    quantize_model(y.model, [np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)])
    vm = y.val(data=fit["data"], batch=2, imgsz=64, verbose=False)
    assert is_quantized(y.model) and y.validator.seen == 4
    assert set(vm.results_dict) == {"metrics/precision(B)", "metrics/recall(B)", "metrics/mAP50(B)",
                                    "metrics/mAP50-95(B)", "fitness"}
    assert all(0.0 <= vm[k] <= 1.0 for k in ("precision", "recall", "mAP50", "mAP50-95", "fitness"))
