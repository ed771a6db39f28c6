"""The classify task's train side in the port vs the JAX package.

Host stack (data/classify.py, numpy, no cv2): the 3x3 Gaussian blur, BGR
<-> YCrCb and the histogram equalisation against cv2 bit for bit; each of
RandAugment's 11 operations against the JAX package's `_randaugment` (cv2)
on the same image and seed, bit for bit, the same operations and signs
drawn; the resize against cv2.resize(INTER_LINEAR) within 1 level (PyTorch's
bilinear rule; cv2 rounds its weights to fixed point). The loader's samples
against JAX's ClassificationDataset.load on the same seeds: every draw
(crop, flip, operations, signs, erasing and its rectangle) the same call
with the same result, the labels equal, the images within 1 level where
no RandAugment operation follows the resize and within 1 level on average
where one does (its factors and thresholds carry a level of the resize
further), and bit for bit once JAX's cv2.resize is replaced by the port's
resize; the train loader's batches against JAX's ClassificationLoader bit
for bit likewise (slots seeded as JAX seeds them).
The classify transforms (ClassifyLetterBox, CenterCrop, ToTensor,
classify_augmentations with JAX's draws, classify_transforms) against
JAX's within the resize's level.

Train: one SGD micro-step (dropout 0, batch 2, fp32) of a compact classify
graph against JAX's _make_train_step: the loss (the cross-entropy of the
fp32 log-softmax, the batch mean) within RTOL, then every parameter and
BatchNorm statistic and the EMA within RTOL / ATOL; the port logs one item
`loss` where JAX logs box 0, cls the loss, dfl 0 (ROADMAP Queue 3). With
dropout 0.5 the step's logits draw a seeded mask (the same seed, the same
loss). The val loader's wrapped last batch: JAX's ClassificationValidator
and the port's count the wrapped image twice (ROADMAP Queue 3). End to end
on the CPU: YOLO("yolov8n-cls.yaml").train on an image folder (RandAugment,
erasing 0.4, dropout 0.1; results.csv's train/loss and metrics columns,
best.pt) and YOLO(best.pt).val equal to the trainer's record.
"""

import copy

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.data import classify as JC
from improving_yolov8_cbam_swinblock_tpu.data import transforms as JT
from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import make_train_state
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data import classify as PC
from improving_yolov8_cbam_swinblock_tpu_torch.engine.trainer import DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import ClassificationValidator
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.test_torch_train import ATOL, RTOL, assert_states_match, tree_state
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
COMPACT = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "C2f", [16, True]],
                                 [-1, 1, "Conv", [32, 3, 2]]],
           "head": [[-1, 1, "Classify", ["nc"]]]}
OPS = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y", "brightness", "contrast", "sharpness",
       "posterize", "solarize", "equalize")


class Recorder:
    """A numpy Generator that logs each call (method, arguments, result)."""

    def __init__(self, seed):
        self.g = np.random.default_rng(seed)
        self.log = []

    def __getattr__(self, name):
        fn = getattr(self.g, name)

        def call(*args, **kw):
            out = fn(*args, **kw)
            self.log.append((name, repr(args), repr(kw), repr(out)))
            return out

        return call


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """train/ and val/ of 3 classes: 6 and 3 images each, 40 to 90 px a side,
    each a colour per class with noise."""
    root = tmp_path_factory.mktemp("clsdata")
    rng = np.random.default_rng(0)
    for split, n in (("train", 6), ("val", 3)):
        for c, color in enumerate([(200, 40, 40), (40, 200, 40), (40, 40, 200)]):
            d = root / split / f"class{c}"
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rng.integers(40, 91, 2)
                img = np.clip(np.asarray(color) + rng.integers(-60, 60, (h, w, 3)), 0, 255).astype(np.uint8)
                cv2.imwrite(str(d / f"{i}.png"), img)
    return root


# ---------------------------------------------------------------------------------------------------------------
# the host stack


def test_cv2_integer_rules_bit_for_bit():
    rng = np.random.default_rng(1)
    for t in range(40):
        img = rng.integers(0, 256, (*rng.integers(3, 70, 2), 3), dtype=np.uint8)
        if t % 2:
            img = (img // 40 * 40).astype(np.uint8)  # few levels: ties in the histogram
        np.testing.assert_array_equal(PC.gaussian_blur3(img), cv2.GaussianBlur(img, (3, 3), 0))
        ycc = cv2.cvtColor(img, cv2.COLOR_BGR2YCrCb)
        np.testing.assert_array_equal(PC.bgr_to_ycrcb(img), ycc)
        np.testing.assert_array_equal(PC.ycrcb_to_bgr(ycc), cv2.cvtColor(ycc, cv2.COLOR_YCrCb2BGR))
        y = np.ascontiguousarray(ycc[..., 0])
        np.testing.assert_array_equal(PC.equalize_hist(y), cv2.equalizeHist(y))
    np.testing.assert_array_equal(PC.equalize_hist(np.full((5, 6), 9, np.uint8)), np.full((5, 6), 9, np.uint8))


def test_randaugment_matches_jax_bit_for_bit():
    """60 seeds on a 64 x 48 image: the port's randaugment and JAX's
    _randaugment draw the same calls and give the same pixels; every one of
    the 11 operations runs at least once."""
    img = np.random.default_rng(2).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    seen = set()
    for seed in range(60):
        jr, pr = Recorder(seed), Recorder(seed)
        want = JC._randaugment(img.copy(), jr)
        got = PC.randaugment(img.copy(), pr)
        assert pr.log == jr.log
        seen.update(OPS[int(i)] for i in np.random.default_rng(seed).integers(0, 11, 2))
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
    assert seen == set(OPS)


def test_resize_within_one_level_of_cv2():
    rng = np.random.default_rng(3)
    for _ in range(20):
        img = rng.integers(0, 256, (*rng.integers(20, 200, 2), 3), dtype=np.uint8)
        oh, ow = (int(v) for v in rng.integers(16, 240, 2))
        d = PC.resize(img, oh, ow).astype(int) - cv2.resize(img, (ow, oh), interpolation=cv2.INTER_LINEAR)
        assert np.abs(d).max() <= 1


def cv2_resize_of_the_port(img, dsize, interpolation=None):
    """cv2.resize(img, (w, h)) computed by the port's resize: JAX's stack then sees the port's pixels."""
    return PC.resize(img, dsize[1], dsize[0])


@pytest.mark.parametrize("augment", [None, "randaugment"])
def test_dataset_load_draws_as_jax(folder, augment, monkeypatch):
    """Every train sample of the folder with erasing 0.5 on the same seeds:
    the same draws (crop, flip, operations and their signs, erasing and its
    rectangle) and the label; the image within 1 level where no RandAugment
    follows the resize and within 1 level on average where it does (its
    factors carry the resize's level further), and bit for bit once JAX's
    cv2.resize is the port's resize; val samples within 1 level."""
    jd = JC.ClassificationDataset(folder / "train", imgsz=32, erasing=0.5, auto_augment=augment)
    pd = PC.ClassificationDataset(folder / "train", imgsz=32, erasing=0.5, auto_augment=augment)
    assert pd.samples == jd.samples and pd.names == jd.names and pd.nc == jd.nc == 3
    erased = 0
    for i in range(len(pd)):
        jr, pr = Recorder(100 + i), Recorder(100 + i)
        want, got = jd.load(i, True, jr), pd.load(i, True, pr)
        assert pr.log == jr.log and got["label"] == want["label"] and got["img"].shape == (32, 32, 3)
        erased += any(name == "uniform" and "0.02" in args for name, args, _, _ in pr.log)
        d = np.abs(got["img"].astype(int) - want["img"])
        assert d.mean() <= 1.0 if augment else d.max() <= 1
        with monkeypatch.context() as mp:
            mp.setattr(cv2, "resize", cv2_resize_of_the_port)
            np.testing.assert_array_equal(got["img"], jd.load(i, True, np.random.default_rng(100 + i))["img"])
    assert erased > 0
    for i in range(len(pd)):
        d = pd.load(i, False, None)["img"].astype(int) - jd.load(i, False, None)["img"]
        assert np.abs(d).max() <= 1


def test_train_loader_batches_as_jax(folder, monkeypatch):
    """Two epochs of the train loader at batch 4 with RandAugment and erasing
    0.4: JAX's labels, batch count and images, bit for bit with JAX's
    cv2.resize made the port's (the same per-slot seeds and draws)."""
    monkeypatch.setattr(cv2, "resize", cv2_resize_of_the_port)
    jl = JC.ClassificationLoader(JC.ClassificationDataset(folder / "train", imgsz=32, erasing=0.4,
                                                          auto_augment="randaugment"), 4, train=True, seed=5, workers=2)
    pl = PC.ClassificationLoader(PC.ClassificationDataset(folder / "train", imgsz=32, erasing=0.4,
                                                          auto_augment="randaugment"), 4, train=True, seed=5, workers=2)
    assert len(pl) == len(jl) == 4
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        for jb, pb in zip(jl, pl):
            np.testing.assert_array_equal(pb["label"], jb["label"])
            assert pb["img"].dtype == np.uint8 and pb["img"].shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(pb["img"], jb["img"])


def test_classify_transforms_match_jax(monkeypatch):
    """ClassifyLetterBox, CenterCrop and ToTensor against JAX's (within the
    resize's level); classify_augmentations drawing from the generator that
    JAX's draws from (seeded here) and classify_transforms likewise."""
    img = np.random.default_rng(4).integers(0, 256, (50, 90, 3), dtype=np.uint8)
    for size in (32, 48):
        for pt, jt in ((PC.ClassifyLetterBox(size), JT.ClassifyLetterBox(size)), (PC.CenterCrop(size),
                                                                                  JT.CenterCrop(size))):
            got, want = pt(img), jt(img)
            assert got.shape == want.shape == (size, size, 3) and np.abs(got.astype(int) - want).max() <= 1
    np.testing.assert_array_equal(PC.ToTensor()(img), JT.ToTensor()(img))
    assert PC.ToTensor(half=True)(img).dtype == np.float16
    for seed in range(8):
        real = np.random.default_rng
        monkeypatch.setattr(np.random, "default_rng", lambda *a: real(seed))
        jaug = JT.classify_augmentations(size=32, hflip=0.5, erasing=0.5)
        monkeypatch.setattr(np.random, "default_rng", real)
        paug = PC.classify_augmentations(size=32, hflip=0.5, erasing=0.5, rng=real(seed))
        got, want = paug(img), jaug(img)
        assert got.shape == want.shape == (3, 32, 32)
        assert (np.abs(got - want) <= 1 / 255 + 1e-6).mean() >= 0.999
    got, want = PC.classify_transforms(size=32)(img), JT.classify_transforms(size=32)(img)
    assert np.abs(got - want).max() <= 1 / 255 + 1e-6


# ---------------------------------------------------------------------------------------------------------------
# the train step


def compact():
    jm = JaxDetectionModel(copy.deepcopy(COMPACT))
    v = seeded_variables(jm, 32, np.random.default_rng(0))
    pm = DetectionModel(copy.deepcopy(COMPACT), device="cpu", dtype=torch.float32, param_dtype=torch.float32)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, pm, v


BATCH = {"img": np.random.default_rng(9).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
         "label": np.array([2, 0], np.int32)}


def test_sgd_micro_step_matches_jax():
    """One micro-step (SGD, batch 2 = nbs, fp32, dropout 0) of the compact
    classify graph: the loss within RTOL of JAX's cls item (JAX's box and
    dfl items are 0; the port logs `loss` only), then the parameters, BN
    statistics and EMA within RTOL / ATOL."""
    jm, pm, v = compact()
    overrides = {"batch": 2, "nbs": 2, "epochs": 10, "imgsz": 32, "optimizer": "SGD", "amp": False, "dropout": 0.0}
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.args = jax_get_cfg(overrides=overrides)
    jt.model = jm
    jstep, _ = jt._make_train_step(nb=100)
    state, m = jstep(make_train_state(v, jt.optimizer_name), {k: jnp.asarray(a) for k, a in BATCH.items()})
    jitems = np.asarray(m)
    pt = DetectionTrainer(overrides=overrides, model=pm, device="cpu").setup()
    pstep, acc = pt._make_train_step(nb=100)
    pitems = pstep(BATCH).numpy()
    assert acc == 1 and pm.task == "classify" and pitems.shape == (1,) and jitems.shape == (3,)
    assert jitems[0] == jitems[2] == 0 and jitems[1] > 0
    np.testing.assert_allclose(pitems[0], jitems[1], rtol=RTOL)
    ref = tree_state(state.params, state.batch_stats)
    got = {k: t.detach().float().numpy() for k, t in pm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref) and "model.3.linear.weight" in got
    assert_states_match(got, ref, 0.0, "params/BN")
    assert_states_match({k: t.numpy() for k, t in pt.ema.items()}, tree_state(state.ema_params, state.ema_stats),
                        0.0, "EMA")


def test_dropout_in_the_train_step():
    """dropout 0.5: the head drops from the trainer's generator seeded by
    `seed`, so two trainers with the same seed give the same loss, another
    seed another one, and each differs from the loss at dropout 0."""
    losses = {}
    for key, (p, seed) in {"a": (0.5, 0), "b": (0.5, 0), "c": (0.5, 1), "none": (0.0, 0)}.items():
        _, pm, _ = compact()
        tr = DetectionTrainer(overrides={"batch": 2, "nbs": 2, "imgsz": 32, "optimizer": "SGD", "amp": False,
                                         "dropout": p, "seed": seed}, model=pm, device="cpu").setup()
        assert pm.model[-1].drop.p == p and pm.model[-1].drop.generator is tr.drop_gen
        losses[key] = tr._make_train_step(nb=100)[0](BATCH).item()
    assert losses["a"] == losses["b"] and losses["a"] != losses["c"] and losses["a"] != losses["none"]


def test_wrapped_last_val_batch_counts_twice(folder):
    """val/ holds 9 images; at batch 4 the third batch wraps to images 0 to
    2: both validators count 12 images, those three twice (a model that
    always ranks class 0 first: top1 = 6 / 12, not 3 / 9)."""
    jl = JC.ClassificationLoader(JC.ClassificationDataset(folder / "val", imgsz=32), 4, train=False, workers=1)
    pl = PC.ClassificationLoader(PC.ClassificationDataset(folder / "val", imgsz=32), 4, train=False, workers=1)
    labels = np.concatenate([b["label"] for b in pl])
    np.testing.assert_array_equal(labels, np.concatenate([b["label"] for b in jl]))
    np.testing.assert_array_equal(labels, [0, 0, 0, 1, 1, 1, 2, 2, 2, 0, 0, 0])
    probs = np.tile(np.array([[0.7, 0.2, 0.1]], np.float32), (4, 1))

    class FirstClass(torch.nn.Module):
        dtype, nc, names, device = torch.float32, 3, {}, torch.device("cpu")

        def forward(self, x):
            return torch.from_numpy(probs[:len(x)])

    jv = JV.ClassificationValidator.__new__(JV.ClassificationValidator)
    jv.model, jv.loader, jv.args = None, jl, None
    jv._forward = lambda variables, img: probs[:len(img)]
    ref = JV.ClassificationValidator.__call__(jv, {})
    pv = ClassificationValidator(FirstClass(), pl, get_cfg({"verbose": False}))
    got = pv()
    assert got["top1"] == ref["top1"] == 0.5 and got["top5"] == ref["top5"] == 1.0 and pv.seen == 12


# ---------------------------------------------------------------------------------------------------------------
# YOLO end to end on the CPU


def test_yolo_trains_and_validates_classify(folder, tmp_path, monkeypatch):
    """YOLO("yolov8n-cls.yaml", device="cpu") trains 2 epochs of 4 micro-steps
    at 32 px on the folder (RandAugment, erasing 0.4, dropout 0.1: the
    defaults but dropout): nc and names from train's class folders,
    results.csv with train/loss and the metrics columns, best.pt; then
    YOLO(best.pt).val on the folder equals the trainer's record."""
    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    y = YOLO("yolov8n-cls.yaml", device="cpu")
    record = y.train(data=str(folder), epochs=2, batch=4, nbs=4, imgsz=32, workers=2, dropout=0.1,
                     project=str(tmp_path / "runs"), verbose=False, amp=False)
    tr = y.trainer
    assert tr.step == 8 and tr.model.nc == 3 and tr.model.names == {0: "class0", 1: "class1", 2: "class2"}
    assert tr.train_loader.ds.auto_augment == "randaugment" and tr.train_loader.ds.erasing == 0.4
    assert set(record) == {"top1", "top5", "fitness"} and record["top5"] == 1.0 and tr.validator.seen == 12
    header = (tr.save_dir / "results.csv").read_text().splitlines()[0].split(",")
    assert {"train/loss", "metrics/top1", "metrics/top5", "metrics/fitness"} <= set(header)
    assert not any(h.startswith("train/") and h != "train/loss" for h in header)
    best = YOLO(str(tr.wdir / "best.pt"), device="cpu")
    out = best.val(data=str(folder), batch=4, imgsz=32, verbose=False)
    assert best.task == "classify" and best.names[2] == "class2"
    assert out["top1"] == pytest.approx(record["top1"]) and out["metrics/accuracy_top5"] == record["top5"]
