"""The pose task's train side in the port vs the JAX package.

The pose loss (utils/pose_loss.py) against JAX's pose_loss on the same
inputs (160 px, 525 anchors, 16 GT boxes a image, 3 masked out): at nd 3
with visibilities 0, 1 and 2, and at nd 2 with every point visible, where
the port takes the loader's targets (the appended visibility column) and
JAX 2-D ones. The total, the five items (box, pose, kobj, cls, dfl) and the
grads of the raw maps and the raw keypoints within 1e-4 of the largest
magnitude (LOSS_TOL: fp32 sums in another order; one jax.jit each); on the
CPU the assigner takes its plain version.

The labels and targets: verify_image_label at nd 3 equal to JAX's; at nd 2
the reference's rule (JAX reads 24 values as 8 points of 3: ROADMAP Queue
3); a detect run's cache, which has no keypoints, rebuilt when it is read
for pose (JAX reuses it); pose_transform's val and train paths against
JAX's on the same samples and generator seed, flip_idx passed to both
(mosaic, mixup, the warps, both flips, the letterbox): keypoints, boxes,
classes and the generator's state exactly, the images within 2 levels (the
host stack's bound); the pose loader's batches equal to the JAX
DataLoader's at fliplr 0 (JAX's loader never swaps left and right: ROADMAP
Queue 3), and with fliplr 1 the port's keypoints are JAX's reordered by the
descriptor's flip_idx. End to end on the CPU: YOLO("yolov8n-pose.yaml")
trains 2 micro-steps with the five loss columns, validates with the (P)
keys, and a descriptor's 2-D kpt_shape replaces the graph's.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.data import augment as JA
from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.data import utils as JU
from improving_yolov8_cbam_swinblock_tpu.utils.pose_loss import pose_loss as jax_pose_loss
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
from improving_yolov8_cbam_swinblock_tpu_torch.data import augment as PA
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.data import utils as PU
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import build_yolo_dataset
from improving_yolov8_cbam_swinblock_tpu_torch.engine.trainer import DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.pose_loss import pose_loss
from tests.test_torch_pose import write_pose_dataset
from tests.test_torch_segment_train import IMAGE_LEVELS, assert_sample_equal
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
LOSS_TOL = 1e-4
NC, IMGSZ, B, G, NK = 2, 160, 2, 16, 17
A = 525  # anchors at 160 px: 20^2 + 10^2 + 5^2
FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]


# ---------------------------------------------------------------------------------------------------------------
# the loss


def loss_inputs(nd):
    """Raw maps (B, 4*16 + nc, H, W) at 160 px, raw keypoints (B, A, 17 nd),
    16 GT boxes a image on a 4 x 4 grid (3 masked out) and their keypoints
    (B, G, 17, 3): near the box, visibility 0, 1 or 2 (all 1 at nd 2)."""
    rng = np.random.default_rng(30 + nd)
    feats = [rng.normal(0, 1, (B, 64 + NC, IMGSZ // s, IMGSZ // s)).astype(np.float32) for s in (8, 16, 32)]
    kraw = rng.normal(0, 1, (B, A, NK * nd)).astype(np.float32)
    cls = rng.integers(0, NC, (B, G)).astype(np.int32)
    cells = (np.stack(np.meshgrid(np.arange(4), np.arange(4)), -1).reshape(G, 2) + 0.5) / 4
    xy = cells[None] + rng.uniform(-0.03, 0.03, (B, G, 2))
    wh = rng.uniform(0.15, 0.24, (B, G, 2))
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    mask = np.ones((B, G), np.float32)
    mask[:, -3:] = 0.0
    kxy = xy[:, :, None] + rng.uniform(-0.5, 0.5, (B, G, NK, 2)) * wh[:, :, None]
    vis = rng.integers(0, 3, (B, G, NK, 1)) if nd == 3 else np.ones((B, G, NK, 1))
    kpts = np.concatenate([kxy, vis], -1).astype(np.float32)
    return feats, kraw, cls, boxes, mask, kpts


@pytest.mark.parametrize("nd", [3, 2])
def test_pose_loss_and_grads_match_jax(nd):
    feats, kraw, cls, boxes, mask, kpts = loss_inputs(nd)
    jkpts = kpts if nd == 3 else kpts[..., :2]  # JAX takes 2-D targets at nd 2

    def jax_total(f, k):
        total, items, (loc, obj) = jax_pose_loss(f, k, cls, boxes, mask, jkpts, nc=NC, kpt_shape=(NK, nd))
        return total, jnp.stack([items.box, loc, obj, items.cls, items.dfl])

    (ref_total, ref_items), ref_grads = jax.jit(jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in feats], jnp.asarray(kraw))
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tk = torch.from_numpy(kraw).requires_grad_()
    before = tal_assign_cuda.launches
    total, items = pose_loss(tf, tk, torch.from_numpy(cls), torch.from_numpy(boxes), torch.from_numpy(mask),
                             torch.from_numpy(kpts), nc=NC, kpt_shape=(NK, nd))
    assert tal_assign_cuda.launches == before  # the CPU: the assigner's plain version
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(ref_total), rtol=LOSS_TOL)
    np.testing.assert_allclose(items.numpy(), np.asarray(ref_items), rtol=LOSS_TOL, atol=1e-7)
    assert float(items[1]) > 0 and (float(items[2]) > 0) == (nd == 3)
    for f, g in zip(tf, ref_grads[0]):
        np.testing.assert_allclose(f.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g), rtol=LOSS_TOL,
                                   atol=LOSS_TOL * float(np.abs(g).max()))
    g = np.asarray(ref_grads[1])
    np.testing.assert_allclose(tk.grad.numpy(), g, rtol=LOSS_TOL, atol=LOSS_TOL * float(np.abs(g).max()))
    if nd == 2:  # the same with the targets' two columns: every point counts
        two, items2 = pose_loss([torch.from_numpy(f) for f in feats], torch.from_numpy(kraw), torch.from_numpy(cls),
                                torch.from_numpy(boxes), torch.from_numpy(mask), torch.from_numpy(jkpts), nc=NC,
                                kpt_shape=(NK, nd))
        assert torch.equal(items2, items) and float(two) == float(total.detach())


# ---------------------------------------------------------------------------------------------------------------
# labels and the cache


def write_labels(root, lines_of):
    """PNG frames and YOLO label files; returns the image paths."""
    import cv2

    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir(parents=True)
    files = []
    for i, lines in enumerate(lines_of):
        f = root / "images" / f"{i}.png"
        cv2.imwrite(str(f), np.full((40, 50, 3), 90, np.uint8))
        (root / "labels" / f"{i}.txt").write_text("\n".join(lines) + "\n")
        files.append(str(f))
    return files


def pose_line(rng, c, nk, nd, negative=False):
    k = rng.uniform(0.05, 0.95, (nk, 2))
    if negative:  # the reference's mark of a point that is not labelled
        k[1] = -1.0
    if nd == 3:
        k = np.concatenate([k, rng.integers(0, 3, (nk, 1))], 1)
    return f"{c} 0.5 0.5 0.4 0.3 " + " ".join(f"{v:.5f}" for v in k.reshape(-1))


def test_verify_image_label_reads_keypoints_by_kpt_shape(tmp_path):
    """nd 3: the port's labels equal JAX's (a box row beside the keypoint
    rows: keypoints None). nd 2 (tiger-pose's (12, 2)): (12, 3) float32
    keypoints with the visibility appended, 0 where x or y is negative, as
    the reference reads them, where JAX reads the 24 values as 8 points of 3.
    A row of another length marks the label corrupt."""
    rng = np.random.default_rng(2)
    f3 = write_labels(tmp_path / "k3", [[pose_line(rng, 0, NK, 3), pose_line(rng, 1, NK, 3), "1 0.5 0.5 0.2 0.2"]])
    got = PU.verify_image_label(f3[0], PU.img_label_paths(f3)[0], NC, (NK, 3))
    ref = JU.verify_image_label(f3[0], JU.img_label_paths(f3)[0], NC, (NK, 3))
    assert {k: got[k] for k in ("nm", "nf", "ne", "ncorrupt")} == {k: ref[k] for k in ("nm", "nf", "ne", "ncorrupt")}
    for k in ("cls", "xywhn"):
        np.testing.assert_array_equal(got["label"][k], ref["label"][k])
    assert len(got["label"]["kpts"]) == len(ref["label"]["kpts"]) == 3 and got["label"]["kpts"][2] is None
    for a, b in zip(got["label"]["kpts"][:2], ref["label"]["kpts"][:2]):
        assert a.dtype == np.float32 and a.shape == (NK, 3)
        np.testing.assert_array_equal(a, b)

    f2 = write_labels(tmp_path / "k2", [[pose_line(rng, 0, 12, 2, negative=True)]])
    lb = PU.img_label_paths(f2)[0]
    got = PU.verify_image_label(f2[0], lb, 1, (12, 2))["label"]["kpts"][0]
    vals = np.asarray(open(lb).read().split()[5:], np.float32).reshape(12, 2)
    assert got.shape == (12, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, :2], vals)
    np.testing.assert_array_equal(got[:, 2], np.where((vals < 0).any(1), 0.0, 1.0))
    assert JU.verify_image_label(f2[0], lb, 1, (12, 2))["label"]["kpts"][0].shape == (8, 3)  # JAX's misreading
    bad = PU.verify_image_label(f2[0], lb, 1, (17, 3))
    assert bad["ncorrupt"] == 1 and "columns" in bad["msg"]


def test_a_cache_without_keypoints_is_rebuilt_for_pose(tmp_path, monkeypatch):
    """A label cache written for detection (the JAX package's payload, kpts
    None) keys no kpt_shape: read for pose, the port rebuilds it (and writes
    it with the keypoints, JAX's payload, which both packages read back),
    where the JAX package reuses it and trains on no keypoints."""
    rng = np.random.default_rng(3)
    files = write_labels(tmp_path, [[pose_line(rng, 0, NK, 3)], [pose_line(rng, 1, NK, 3), pose_line(rng, 0, NK, 3)]])
    cache = tmp_path / "labels.cache"
    JU.load_or_build_cache(files, NC)  # a detect run's cache
    assert all(k is None for lab in pickle.loads(cache.read_bytes())["labels"] for k in lab["kpts"])
    assert all(k is None for lab in JU.load_or_build_cache(files, NC, (NK, 3))[0] for k in lab["kpts"])
    labels, _ = PU.load_or_build_cache(files, NC, (NK, 3))
    assert [len(lab["kpts"]) for lab in labels] == [1, 2] and all(k.shape == (NK, 3) for lab in labels
                                                                   for k in lab["kpts"])
    ref, _ = JU.load_or_build_cache(files, NC, (NK, 3))  # the rewritten cache, read by JAX as it is
    assert all(np.array_equal(a, b) for la, lb in zip(labels, ref) for a, b in zip(la["kpts"], lb["kpts"]))
    monkeypatch.setattr(PU, "verify_image_label", lambda *a, **k: pytest.fail("rebuilt a cache with keypoints"))
    assert len(PU.load_or_build_cache(files, NC, (NK, 3))[0]) == 2
    assert len(PU.load_or_build_cache(files, NC)[0]) == 2  # detection reads it as it is


# ---------------------------------------------------------------------------------------------------------------
# pose_transform and the loader


def pose_sample(i, shape=None):
    """A loader sample: a BGR frame (of `shape`, or one of four), 1 to 5
    instances with 17 keypoints of 3 (normalised, visibility 0, 1 or 2),
    the last of every third sample without keypoints."""
    r = np.random.default_rng(100 + i)
    h, w = shape or [(120, 160), (80, 100), (160, 120), (64, 180)][i % 4]
    img = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    n = int(r.integers(1, 6))
    boxes, kpts = [], []
    for j in range(n):
        c, s = r.uniform(0.25, 0.75, 2), r.uniform(0.15, 0.45, 2)
        boxes.append(np.concatenate([c - s / 2, c + s / 2]) * np.array([w, h, w, h]))
        k = np.concatenate([np.clip(c + r.uniform(-0.6, 0.6, (NK, 2)) * s, 0, 1), r.integers(0, 3, (NK, 1))], 1)
        kpts.append(None if j == n - 1 and i % 3 == 0 else k.astype(np.float32))
    return {"img": img, "bboxes": np.array(boxes, np.float32), "cls": (np.arange(n) % NC).astype(np.float32),
            "segments": [None] * n, "kpts": kpts}


HYP = dict(mosaic=1.0, mixup=0.5, degrees=10.0, shear=2.0, perspective=5e-4, translate=0.1, scale=0.5, flipud=0.5,
           fliplr=0.5, hsv_h=0.015, hsv_s=0.7, hsv_v=0.4, pixel_augment=1.0, copy_paste=0.0)
CASES = {"val": (False, {}, FLIP_IDX), "train": (True, {}, FLIP_IDX), "train_no_flip_idx": (True, {}, None),
         "train_letterbox": (True, {"mosaic": 0.0, "perspective": 0.0, "fliplr": 1.0}, FLIP_IDX)}


@pytest.mark.parametrize("case", list(CASES))
def test_pose_transform_matches_jax(case):
    """Four seeds each: every key of the sample equal (the images within 2
    levels), the generator in the same state after, keypoints in the targets."""
    train, extra, flip_idx = CASES[case]
    hyp = {**HYP, **extra}
    visible = 0
    for t in range(4):
        shape = (96, 128) if case == "train_letterbox" else None
        samples = [pose_sample(t * 8 + k, shape=shape) for k in range(8)]
        rj, rp = np.random.default_rng(t), np.random.default_rng(t)
        ref = JA.pose_transform(samples if train else samples[0], 128, 16, (NK, 3), train, rj, hyp, flip_idx=flip_idx)
        got = PA.pose_transform(samples if train else samples[0], 128, 16, (NK, 3), train, rp, hyp, flip_idx=flip_idx)
        assert_sample_equal(got, ref)
        assert rj.bit_generator.state == rp.bit_generator.state
        assert got["kpts"].shape == (16, NK, 3) and got["kpts"].dtype == np.float32
        visible += int((got["kpts"][..., 2] > 0).sum())
    assert visible > 0


@pytest.fixture(scope="module")
def pose_data(tmp_path_factory):
    return write_pose_dataset(tmp_path_factory.mktemp("posedata"), flip_idx=FLIP_IDX)


def loaders(data, train, hyp):
    """The port's loader over the data descriptor (its flip_idx read from it)
    and the JAX package's over the same split (JAX's dataset has no flip_idx)."""
    info = PD.check_det_dataset(str(data))
    split = info["train" if train else "val"]
    args = get_args()
    pl = PD.DataLoader(build_yolo_dataset(args, split, info, mode="train" if train else "val", kpt_shape=(NK, 3)), 2,
                       train=train, hyp=hyp, workers=1, task="pose", rect_shape=(64, 96))
    jl = JD.DataLoader(JD.YOLODataset(split, imgsz=64, max_gt=8, nc=NC, kpt_shape=(NK, 3)), 2, train=train, hyp=hyp,
                       workers=1, task="pose")
    return pl, jl


def get_args():
    from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg

    return get_cfg({"imgsz": 64, "max_gt": 8})


@pytest.mark.parametrize("train", [False, True])
def test_pose_loader_matches_jax_without_flips(pose_data, train):
    """The pose loader's batches (train: the host stack with mixup, fliplr 0;
    val: the letterbox, never rect) against the JAX DataLoader's."""
    pl, jl = loaders(pose_data, train, {**HYP, "mixup": 0.5, "fliplr": 0.0})
    assert pl.device_augment is False and pl.rect_shape is None and pl.ds.flip_idx == FLIP_IDX
    n = 0
    for got, ref in zip(pl, jl):
        assert_sample_equal(got, ref)
        n += 1
    assert n == len(jl) == 2


def test_pose_loader_swaps_keypoints_by_the_descriptors_flip_idx(pose_data):
    """With fliplr 1 the port's keypoints are JAX's reordered by flip_idx
    (read from the data descriptor): JAX's loader hands flip_inst no
    flip_idx, so its left eye stays the left eye of the mirrored image."""
    pl, jl = loaders(pose_data, True, {**HYP, "fliplr": 1.0})
    for got, ref in zip(pl, jl):
        assert np.abs(got["img"].astype(int) - ref["img"]).max() <= IMAGE_LEVELS
        np.testing.assert_array_equal(got["bboxes"], ref["bboxes"])
        np.testing.assert_array_equal(got["kpts"], ref["kpts"][:, :, FLIP_IDX])
        assert not np.array_equal(got["kpts"], ref["kpts"])


# ---------------------------------------------------------------------------------------------------------------
# YOLO end to end on the CPU


def test_yolo_trains_and_validates_pose(tmp_path, monkeypatch):
    """YOLO("yolov8n-pose.yaml", device="cpu"): one epoch of 2 micro-steps at
    64 px in fp32 (the host stack with flip_idx, the pose loss, val each
    epoch: results.csv with the five loss columns and the (P) metrics,
    best.pt), and YOLO(best.pt).val equal to the trainer's record, with the
    (B) and (P) keys, `.box` and `.pose`."""
    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    data = write_pose_dataset(tmp_path / "data", flip_idx=FLIP_IDX)
    y = YOLO("yolov8n-pose.yaml", device="cpu")
    record = y.train(data=str(data), epochs=1, batch=2, nbs=2, imgsz=64, workers=1, project=str(tmp_path / "runs"),
                     verbose=False, amp=False)
    assert y.trainer.step == 2 and y.trainer.train_loader.ds.flip_idx == FLIP_IDX
    csv = (y.trainer.save_dir / "results.csv").read_text().splitlines()
    assert all(f"train/{k}_loss" in csv[0] for k in ("box", "pose", "kobj", "cls", "dfl"))
    assert "metrics/mAP50-95(P)" in csv[0] and all(np.isfinite(float(v)) for v in csv[1].split(","))
    best = YOLO(str(y.trainer.wdir / "best.pt"), device="cpu")
    assert best.task == "pose"
    vm = best.val(data=str(data), batch=2, imgsz=64, workers=1, verbose=False)
    assert {k: record[k] for k in record} == pytest.approx({k: vm[k] for k in record}, abs=1e-6)
    assert vm.pose is not None and vm.box is not None and "metrics/mAP50(P)" in vm.results_dict
    assert vm["mAP50-95"] == vm["mAP50-95(P)"]


def test_a_2d_descriptor_replaces_the_graphs_kpt_shape(tmp_path):
    """A descriptor with kpt_shape [5, 2] (as tiger-pose's [12, 2]): the
    trainer builds yolov8n-pose with (5, 2) keypoints, the loader reads them
    with the appended visibility, and a micro-step gives finite items, kobj 0."""
    data = write_pose_dataset(tmp_path / "data", kpt_shape=(5, 2))
    tr = DetectionTrainer(overrides={"model": "yolov8n-pose.yaml", "data": str(data), "batch": 2, "nbs": 2,
                                     "imgsz": 64, "workers": 1, "amp": False, "project": str(tmp_path / "runs")},
                          device="cpu").setup()
    assert tr.model.kpt_shape == (5, 2) and tr.model.model[-1].cv4[0][2].out_channels == 10
    batch = next(iter(tr.train_loader))
    assert batch["kpts"].shape == (2, tr.args.max_gt, 5, 3) and set(np.unique(batch["kpts"][..., 2])) <= {0.0, 1.0}
    items = tr.train_step(batch)
    assert items.shape == (5,) and torch.isfinite(items).all() and float(items[2]) == 0.0
