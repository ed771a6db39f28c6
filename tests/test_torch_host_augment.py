"""The port's host augmentation stack (data/augment.py, device_augment=False)
against the JAX package's numpy/cv2 data/augment.py.

Each transform takes the same samples and a generator seeded the same way.
Held exactly: the boxes (to 1e-4 px), the classes and the kept boxes, and
the generator's bit_generator.state after the call (the same draws in the
same order). The images: the port writes cv2's operations in numpy after the
rules of the cv2 build the JAX package runs with, and is held to these
bounds (the readings are printed):
  * mosaic 2x2, 3x3 and 1x3, flips, mixup, warpAffine, warpPerspective, the
    box blur, the median, BGR -> gray, CLAHE's own arithmetic, BGR -> HSV:
    equal (0 values differ);
  * HSV -> BGR: equal on rows whose width is a multiple of cv2's vector step
    (the 64 and 96 px here); on a row's tail cv2 rounds where its vector path
    truncates, so a width of 100 px differs by 1 level on 0.9 to 1.5 % of
    the values (at most HSV_TAIL_SHARE);
  * CLAHE between its LAB conversions (BGR -> LAB in cv2's integer tables,
    L exact; LAB -> BGR the float formula, where cv2 uses integer tables): at
    most CLAHE_LEVELS levels on at most CLAHE_SHARE of the values (read: 1
    level on 4.8 %);
  * train_transform's letterbox (no mosaic) resizes with PyTorch's bilinear,
    as the device path's does (tests/test_torch_data.py); here the frames
    need no resize.
A stub generator forces each pixel_augment branch. The loader: two epochs of
the port's DataLoader(device_augment=False) against the JAX DataLoader on
the same files, close_mosaic before the second, equal batch for batch.
"""

import numpy as np
import pytest

from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.data import augment as JA
from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.data.build import HYP_KEYS as JAX_HYP_KEYS
from improving_yolov8_cbam_swinblock_tpu_torch.data import augment as PA
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import HYP_KEYS
from tests.synth_data import make_synth_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

CLAHE_LEVELS, CLAHE_SHARE = 2, 0.1
HSV_TAIL_SHARE = 0.05
HYPS = {
    "defaults": {},
    "degrees_shear_perspective": {"degrees": 10.0, "shear": 2.0, "perspective": 5e-4, "flipud": 0.5},
    "mixup_mosaic9": {"mixup": 0.5, "mosaic9": 0.5},
    "mosaic3": {"mosaic3": 0.7},
    "flipud": {"flipud": 1.0, "fliplr": 0.0},
    "letterbox": {"mosaic": 0.0, "degrees": 5.0},
}


def base_hyp():
    return {k: getattr(jax_get_cfg(), k) for k in JAX_HYP_KEYS}


def picture(rng, h, w):
    """A frame with smooth regions, edges and noise."""
    low = rng.integers(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.float32)
    img = np.repeat(np.repeat(low, 8, 0), 8, 1)[:h, :w]
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def sample(rng, h, w, n=4):
    xy = rng.uniform(0, 1, (n, 2)) * [w * 0.7, h * 0.7]
    wh = rng.uniform(0.1, 0.3, (n, 2)) * [w, h]
    return {"img": picture(rng, h, w), "bboxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
            "cls": rng.integers(0, 3, n).astype(np.float32)}


def samples(seed, n=13, sizes=((64, 64), (48, 64), (64, 40), (56, 56))):
    rng = np.random.default_rng(seed)
    return [sample(rng, *sizes[i % len(sizes)]) for i in range(n)]


def copies(ss):
    return [{k: v.copy() for k, v in s.items()} for s in ss]


def pixel_diff(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(int) - b.astype(int))
    return float((d > 0).mean()), int(d.max())


def assert_same_labels(got, ref, px=1.0):
    np.testing.assert_allclose(np.asarray(got["bboxes"]) * px, np.asarray(ref["bboxes"]) * px, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["cls"], ref["cls"])


def run_both(fn_port, fn_jax, seed, *args, **kw):
    """(port's result, JAX's result), each from default_rng(seed); the two generators end in the same state."""
    rp, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got, ref = fn_port(*args, rng=rp, **kw), fn_jax(*args, rng=rj, **kw)
    assert rp.bit_generator.state == rj.bit_generator.state
    return got, ref


@pytest.mark.parametrize("kind", ["mosaic4", "mosaic9", "mosaic3"])
@pytest.mark.parametrize("seed", [0, 1])
def test_mosaics_match_jax(kind, seed):
    ss = samples(seed)
    got, ref = run_both(getattr(PA, kind), getattr(JA, kind), seed, copies(ss), 64)
    assert got["mosaic_border"] == ref["mosaic_border"]
    assert_same_labels(got, ref)
    assert pixel_diff(got["img"], ref["img"]) == (0.0, 0)


@pytest.mark.parametrize("warp", [{}, {"degrees": 10.0, "shear": 2.0}, {"degrees": 10.0, "shear": 2.0,
                                                                        "perspective": 5e-4}, {"scale": 0.9}])
def test_random_perspective_matches_jax(warp):
    """The warp of a 2s mosaic canvas into s (the border of -s/2), over 4 seeds:
    the same boxes, classes and kept boxes, and the same pixels."""
    for seed in range(4):
        m = JA.mosaic4(copies(samples(seed)), 64, np.random.default_rng(seed))
        border = m.pop("mosaic_border")
        got, ref = run_both(lambda s, rng, **k: PA.random_perspective(s, rng, **k),
                            lambda s, rng, **k: JA.random_perspective(s, rng, **k),
                            seed + 10, m, border=border, **warp)
        assert_same_labels(got, ref)
        share, levels = pixel_diff(got["img"], ref["img"])
        print(warp, seed, f"{len(ref['cls'])} boxes kept; {share:.4%} of values differ, at most {levels}")
        assert levels == 0


@pytest.mark.parametrize("w", [64, 96, 100])
def test_random_hsv_matches_jax(w):
    for seed in range(3):
        img = picture(np.random.default_rng(seed), 48, w)
        got, ref = run_both(PA.random_hsv, JA.random_hsv, seed, img.copy())
        share, levels = pixel_diff(got, ref)
        print(f"width {w}, seed {seed}: {share:.4%} of values differ, at most {levels}")
        if w % 32:
            assert levels <= 1 and share <= HSV_TAIL_SHARE
        else:
            assert levels == 0


def test_flips_and_mixup_match_jax():
    ss = samples(3)
    for fn in ("random_flip_lr", "random_flip_ud"):
        for seed in range(4):
            got, ref = run_both(getattr(PA, fn), getattr(JA, fn), seed, copies(ss)[0], p=0.5)
            assert_same_labels(got, ref)
            assert np.array_equal(got["img"], ref["img"])
    a, b = copies(ss[:1])[0], copies(ss[4:5])[0]
    got, ref = run_both(PA.mixup, JA.mixup, 5, a, b)
    assert_same_labels(got, ref)
    assert np.array_equal(got["img"], ref["img"])


class Scripted:
    """A generator stub that answers random(), integers() and uniform() from lists, recording the calls."""

    def __init__(self, randoms, integers=(), uniforms=()):
        self.answers = {"random": list(randoms), "integers": list(integers), "uniform": list(uniforms)}
        self.calls = []

    def _next(self, kind, args):
        self.calls.append((kind, args))
        return self.answers[kind].pop(0)

    def random(self):
        return self._next("random", ())

    def integers(self, lo, hi):
        return self._next("integers", (lo, hi))

    def uniform(self, lo, hi):
        return self._next("uniform", (lo, hi))


@pytest.mark.parametrize("branch,shape", [("blur", (96, 128)), ("median", (96, 128)), ("gray", (96, 128)),
                                          ("clahe", (96, 128)), ("clahe", (100, 77)), ("all", (64, 64))])
def test_pixel_augment_branches_match_jax(branch, shape):
    """Each branch forced by a scripted generator (its draws in the JAX order):
    blur k=5 and median k=7 (integers 2 and 3), gray, CLAHE at clip 2.7."""
    order = ("blur", "median", "gray", "clahe")
    fire = [0.0] + [0.0 if branch in (b, "all") else 0.5 for b in order]
    ints = [i for b, i in (("blur", 2), ("median", 3)) if branch in (b, "all")]
    unis = [2.7] if branch in ("clahe", "all") else []
    img = picture(np.random.default_rng(4), *shape)
    rp, rj = Scripted(fire, ints, unis), Scripted(fire, ints, unis)
    got, ref = PA.pixel_augment(img.copy(), rp), JA.pixel_augment(img.copy(), rj)
    assert rp.calls == rj.calls and not any(rp.answers.values())
    share, levels = pixel_diff(got, ref)
    print(f"{branch} {shape}: {share:.4%} of values differ, at most {levels}")
    if branch in ("clahe", "all"):
        assert levels <= CLAHE_LEVELS and share <= CLAHE_SHARE
    else:
        assert levels == 0


def test_clahe_and_lab_alone():
    """CLAHE's arithmetic equals cv2's on the same L plane; BGR -> LAB is cv2's (L exact)."""
    import cv2

    rng = np.random.default_rng(6)
    for h, w in ((96, 128), (100, 77), (64, 64)):
        gray = cv2.GaussianBlur(rng.integers(0, 256, (h, w), dtype=np.uint8), (0, 0), 3)
        for clip in (1.0, 2.7, 4.0):
            ref = cv2.createCLAHE(clipLimit=clip, tileGridSize=(8, 8)).apply(gray)
            assert np.array_equal(PA.clahe(gray, clip), ref)
        img = picture(rng, h, w)
        share, levels = pixel_diff(PA.bgr_to_lab(img), cv2.cvtColor(img, cv2.COLOR_BGR2LAB))
        print(f"BGR -> LAB {h}x{w}: {share:.4%} of values differ, at most {levels}")
        assert np.array_equal(PA.bgr_to_lab(img)[..., 0], cv2.cvtColor(img, cv2.COLOR_BGR2LAB)[..., 0])
        assert levels <= 1 and share <= 1e-3


@pytest.mark.parametrize("hyp", list(HYPS))
def test_train_transform_matches_jax(hyp):
    """The whole pipeline for one output image at imgsz 64, over 4 seeds: the
    same boxes (to 1e-4 px), classes, mask and generator state, the same pixels."""
    h = {**base_hyp(), **HYPS[hyp]}
    for seed in range(4):
        ss = samples(seed, sizes=((64, 64),) if hyp == "letterbox" else ((64, 64), (48, 64), (64, 40), (56, 56)))
        got, ref = run_both(lambda s, rng: PA.train_transform(s, 64, 24, rng, h),
                            lambda s, rng: JA.train_transform(s, 64, 24, rng, h), seed, copies(ss))
        assert set(got) == set(ref)
        assert_same_labels(got, ref, px=64.0)
        np.testing.assert_array_equal(got["mask"], ref["mask"])
        share, levels = pixel_diff(got["img"], ref["img"])
        print(hyp, seed, f"{int(ref['mask'].sum())} boxes; {share:.4%} of values differ, at most {levels}")
        assert levels == 0


@pytest.fixture(scope="module")
def host_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("host")
    make_synth_dataset(root, n_train=6, n_val=2, imgsz=64, nc=3, seed=5)
    return root


@pytest.mark.parametrize("hyp", ["defaults", "degrees_shear_perspective", "mixup_mosaic9"])
def test_host_loader_matches_jax(host_data, hyp):
    """Two epochs of 2 batches of 3, close_mosaic before the second: the same
    batches as the JAX DataLoader(device_augment=False), without `aug`."""
    h = {**base_hyp(), **HYPS[hyp]}
    assert HYP_KEYS == JAX_HYP_KEYS
    img_dir = str(host_data / "images" / "train")
    jl = JD.DataLoader(JD.YOLODataset(img_dir, imgsz=64, max_gt=24, nc=3), 3, train=True, hyp=dict(h), seed=0,
                       workers=2, device_augment=False)
    pl = PD.DataLoader(PD.YOLODataset(img_dir, imgsz=64, max_gt=24, nc=3), 3, train=True, hyp=dict(h), seed=0,
                       workers=2, device_augment=False)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        if epoch == 1:
            jl.close_mosaic()
            pl.close_mosaic()
        assert pl.hyp["mosaic"] == (1.0 if epoch == 0 else 0.0)
        n = 0
        for got, ref in zip(pl, jl):
            assert set(got) == set(ref) == {"img", "cls", "bboxes", "mask"}
            for k in ("cls", "bboxes", "mask"):
                np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
            assert np.array_equal(got["img"], ref["img"])
            n += 1
        assert n == len(jl) == 2
