"""The port's data path vs the JAX package's: image decode, labels and their
cache, check_det_dataset, and the loader.

Decode: the port's own PNG decoder (forced, though cv2 imports) equals
cv2.imdecode bit for bit on PNGs that cv2 wrote (gray, BGR, BGRA), on PIL's
palette PNGs, and on PNGs written row by row with each of the five filters
(gray, gray + alpha, RGB, RGBA, palette, 1/2/4-bit gray and palette);
image_size equals PIL's (w, h) on PNG, JPEG and BMP.

Loader: two epochs (seed 0) of the device-augmented train loader and of the
val loader, square and rect, against the JAX DataLoader on the same files:
the same image order; `img` bit for bit where no resize happens and within
2 levels where one does (the share of pixels that differ is printed); cls,
bboxes, mask, ratio_pad and orig_shape to 1e-6; `aug` equal, before and
after close_mosaic. Both packages decode with cv2 in these tests.
"""

import pickle
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest
import yaml
from PIL import Image

from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.data import dataset as JD
from improving_yolov8_cbam_swinblock_tpu.data import utils as JU
from improving_yolov8_cbam_swinblock_tpu.data.build import HYP_KEYS as JAX_HYP_KEYS
from improving_yolov8_cbam_swinblock_tpu_torch.data import dataset as PD
from improving_yolov8_cbam_swinblock_tpu_torch.data import utils as PU
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import HYP_KEYS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import decode_png, image_size, imread
from tests.synth_data import make_synth_dataset, make_valparity_dataset
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def encode_png(px: np.ndarray, ctype: int, depth: int = 8, palette=None, filters=(0, 1, 2, 3, 4)) -> bytes:
    """A PNG of px (h, w, channels) raw values, row y filtered with filters[y % len]."""
    h, w, ch = px.shape
    if depth < 8:
        bits = ((px[..., 0][..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8).reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    else:
        rows = px.reshape(h, w * ch).astype(np.uint8)
    bpp = max(1, ch * depth // 8)
    out, prev = bytearray(), [0] * rows.shape[1]
    for y in range(h):
        x, f = [int(v) for v in rows[y]], filters[y % len(filters)]
        enc = []
        for i, v in enumerate(x):
            a = x[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][f]
            enc.append((v - pred) & 0xFF)
        out += bytes([f] + enc)
        prev = x

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
    if palette is not None:
        body += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


def cv2_decode(buf: bytes) -> np.ndarray:
    return cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)


@pytest.mark.parametrize("ctype,depth", [(0, 8), (4, 8), (2, 8), (6, 8), (3, 8), (0, 1), (0, 2), (0, 4), (3, 4),
                                         (3, 1)])
def test_png_decoder_each_filter_matches_cv2(ctype, depth):
    rng = np.random.default_rng(ctype * 10 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    hi = 1 << depth
    px = rng.integers(0, hi, (11, 13, ch), dtype=np.int64)
    px[:, :6] = np.arange(6)[None, :, None] % hi  # a smooth part next to the noise
    palette = rng.integers(0, 256, (hi, 3)) if ctype == 3 else None
    buf = encode_png(px, ctype, depth, palette)
    np.testing.assert_array_equal(decode_png(buf), cv2_decode(buf))


def test_png_decoder_matches_cv2_on_cv2_and_pil_files(tmp_path):
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:37, 0:53]
    smooth = ((yy * 3 + xx * 5) % 256).astype(np.uint8)
    noise = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    bgr = np.stack([smooth, noise, (smooth // 2 + noise // 2)], -1)
    files = {"gray.png": smooth, "bgr.png": bgr, "bgra.png": np.concatenate([bgr, noise[..., None]], -1)}
    for name, img in files.items():
        cv2.imwrite(str(tmp_path / name), img)
    rgb = Image.fromarray(bgr[..., ::-1].copy())
    rgb.quantize(256).save(tmp_path / "palette256.png")
    rgb.quantize(16).save(tmp_path / "palette16.png")
    for f in sorted(tmp_path.glob("*.png")):
        buf = f.read_bytes()
        np.testing.assert_array_equal(decode_png(buf), cv2_decode(buf), err_msg=f.name)
        np.testing.assert_array_equal(imread(f, decoder="png"), imread(f, decoder="cv2"), err_msg=f.name)
        np.testing.assert_array_equal(imread(f, decoder="pil"), imread(f, decoder="cv2"), err_msg=f.name)


def test_image_size_matches_pil(tmp_path):
    img = np.random.default_rng(1).integers(0, 256, (29, 71, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "a.png"), img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    cv2.imwrite(str(tmp_path / "c.bmp"), img)
    Image.fromarray(img).save(tmp_path / "d.jpg", progressive=True, quality=80)
    Image.fromarray(img[:, :40]).save(tmp_path / "e.bmp")
    for f, fmt in (("a.png", "png"), ("b.jpg", "jpeg"), ("c.bmp", "bmp"), ("d.jpg", "jpeg"), ("e.bmp", "bmp")):
        with Image.open(tmp_path / f) as im:
            assert image_size(tmp_path / f) == (*im.size, fmt)
    (tmp_path / "f.txt").write_text("not an image")
    with pytest.raises(ValueError, match="not a PNG, JPEG, BMP, TIFF or WebP"):
        image_size(tmp_path / "f.txt")


def test_imread_without_a_jpeg_decoder_raises_naming_the_file(tmp_path):
    cv2.imwrite(str(tmp_path / "x.jpg"), np.zeros((12, 12, 3), np.uint8))
    with pytest.raises(RuntimeError, match="x.jpg"):
        imread(tmp_path / "x.jpg", decoder="png")
    assert imread(tmp_path / "missing.png") is None


# ---------------------------------------------------------------------------
# labels, cache, data YAML
# ---------------------------------------------------------------------------


def make_label_split(root: Path):
    """images/train with a normal, a missing, an empty, a segment-row, an
    off-range-coordinate and a too-small image, plus one with an out-of-range class."""
    img_dir, lbl_dir = root / "images" / "train", root / "labels" / "train"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir(parents=True)
    labels = {
        "a": "0 0.5 0.5 0.2 0.3\n1 0.25 0.4 0.1 0.1\n",
        "b": None,
        "c": "",
        "d": "2 0.1 0.1 0.4 0.1 0.4 0.5 0.1 0.5\n0 0.6 0.6 0.2 0.2\n",
        "e": "1 1.2 0.5 0.3 0.3\n",
        "f": "0 0.5 0.5 0.5 0.5\n",
        "g": "5 0.5 0.5 0.2 0.2\n",
    }
    rng = np.random.default_rng(2)
    for name, text in labels.items():
        size = (8, 8) if name == "f" else (24, 32)
        cv2.imwrite(str(img_dir / f"{name}.png"), rng.integers(0, 256, (*size, 3), dtype=np.uint8))
        if text is not None:
            (lbl_dir / f"{name}.txt").write_text(text)
    return sorted(str(p) for p in img_dir.glob("*.png"))


def assert_labels_equal(got, ref):
    labels, stats = got
    ref_labels, ref_stats = ref
    assert {k: stats[k] for k in ("nm", "nf", "ne", "ncorrupt")} == {k: ref_stats[k] for k in ("nm", "nf", "ne",
                                                                                               "ncorrupt")}
    assert len(stats["msgs"]) == len(ref_stats["msgs"])
    assert [m for m in stats["msgs"] if "corrupt image" not in m] == [m for m in ref_stats["msgs"]
                                                                      if "corrupt image" not in m]
    assert len(labels) == len(ref_labels)
    for a, b in zip(labels, ref_labels):
        np.testing.assert_array_equal(a["cls"], b["cls"])
        np.testing.assert_array_equal(a["xywhn"], b["xywhn"])
        assert len(a["segments"]) == len(b["segments"])
        for s, t in zip(a["segments"], b["segments"]):
            assert (s is None and t is None) or np.array_equal(s, t)


def test_label_cache_matches_jax_and_reads_its_file(tmp_path, monkeypatch):
    files = make_label_split(tmp_path)
    cache = tmp_path / "labels" / "train.cache"
    ref = JU.load_or_build_cache(files, 3)
    cache.unlink()
    got = PU.load_or_build_cache(files, 3)
    assert_labels_equal(got, ref)
    assert got[1]["ncorrupt"] == 2 and got[1]["nm"] == 1 and got[1]["ne"] == 1
    # a cache the JAX package wrote is read as it is, with no image or label parsed again
    cache.unlink()
    JU.load_or_build_cache(files, 3)
    monkeypatch.setattr(PU, "verify_image_label", lambda *a, **k: pytest.fail("rebuilt a valid cache"))
    assert_labels_equal(PU.load_or_build_cache(files, 3), ref)
    payload = pickle.loads(cache.read_bytes())
    assert payload["version"] == PU.CACHE_VERSION == JU.CACHE_VERSION


def test_check_det_dataset_matches_jax(tmp_path, monkeypatch):
    from improving_yolov8_cbam_swinblock_tpu.utils.settings import SETTINGS as JAX_SETTINGS
    from improving_yolov8_cbam_swinblock_tpu_torch.utils.settings import SETTINGS

    for s in (JAX_SETTINGS, SETTINGS):  # each package's settings file holds its own datasets_dir
        monkeypatch.setitem(s, "datasets_dir", str(tmp_path / "datasets"))
    (tmp_path / "cfg").mkdir()
    y = tmp_path / "cfg" / "data.yaml"
    y.write_text(yaml.safe_dump({"path": "..", "train": "images/train", "val": "images/val",
                                 "test": str(tmp_path / "t"), "names": ["a", "b"]}))
    assert PD.check_det_dataset(str(y)) == JD.check_det_dataset(str(y))
    d = {"path": str(tmp_path), "train": "images/train", "nc": 2}
    assert PD.check_det_dataset(d) == JD.check_det_dataset(d)
    got, ref = PD.check_det_dataset("coco8.yaml"), JD.check_det_dataset("coco8.yaml")
    assert {k: v for k, v in got.items() if k != "yaml_file"} == {k: v for k, v in ref.items() if k != "yaml_file"}


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


def add_nonsquare(root: Path, sizes, seed):
    """Extra val images of other shapes, with labels."""
    rng = np.random.default_rng(seed)
    for k, (h, w) in enumerate(sizes):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        cv2.rectangle(img, (w // 4, h // 4), (w // 2, h // 2), (255, 64, 64), -1)
        cv2.imwrite(str(root / "images" / "val" / f"z{k}.png"), img)
        (root / "labels" / "val" / f"z{k}.txt").write_text("0 0.375 0.375 0.25 0.25\n")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """64 px images (no resize at imgsz 64) and 80 px images plus larger non-square ones (resizes)."""
    exact = tmp_path_factory.mktemp("exact")
    make_synth_dataset(exact, n_train=6, n_val=4, imgsz=64, nc=3, seed=3)
    add_nonsquare(exact, [(48, 64), (64, 40)], 4)
    resize = tmp_path_factory.mktemp("resize")
    make_synth_dataset(resize, n_train=6, n_val=3, imgsz=80, nc=3, seed=5)
    add_nonsquare(resize, [(60, 100), (90, 70), (50, 50)], 6)
    return {"exact": exact, "resize": resize}


def compare_batches(got, ref, exact):
    assert set(got) == set(ref)
    assert got["img"].shape == ref["img"].shape and got["img"].dtype == ref["img"].dtype == np.uint8
    diff = np.abs(got["img"].astype(int) - ref["img"].astype(int))
    if exact:
        assert diff.max() == 0
    else:
        assert diff.max() <= 2, diff.max()
    for k in set(got) - {"img"}:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6, err_msg=k)
    return int((diff > 0).sum()), diff.size


@pytest.mark.parametrize("kind", ["exact", "resize"])
@pytest.mark.parametrize("mode", ["train", "val", "rect"])
def test_loader_matches_jax(datasets, kind, mode):
    root = datasets[kind]
    split = "train" if mode == "train" else "val"
    jds = JD.YOLODataset(str(root / "images" / split), imgsz=64, max_gt=8, nc=3)
    pds = PD.YOLODataset(str(root / "images" / split), imgsz=64, max_gt=8, nc=3)
    hyp = {k: getattr(jax_get_cfg(), k) for k in JAX_HYP_KEYS}
    rect = None
    if mode == "rect":
        rect = pds.rect_shape(32)
        assert rect == jds.rect_shape(32)
    kw = dict(train=mode == "train", hyp=hyp, seed=0, workers=3, rect_shape=rect)
    jl = JD.DataLoader(jds, 4, device_augment=True, **kw)
    pl = PD.DataLoader(pds, 4, **kw)
    assert len(pl) == len(jl)
    differ = total = 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        if epoch == 1:
            jl.close_mosaic()
            pl.close_mosaic()
        np.testing.assert_array_equal(pl._indices(), jl._indices())
        n = 0
        for got, ref in zip(pl, jl):
            d, t = compare_batches(got, ref, exact=kind == "exact")
            differ, total, n = differ + d, total + t, n + 1
            if mode == "train":
                assert got["aug"][0] == (1.0 if epoch == 0 else 0.0)
        assert n == len(jl)
    print(f"{kind} {mode}: {differ} of {total} pixel values differ ({differ / total:.2%})")


def test_port_loads_without_cv2_and_pil(tmp_path):
    """In a process where cv2 and PIL cannot be imported: the package
    imports, the loader yields a train batch (device path and host
    augmentation stack) and a val batch from PNGs (the port's own decoder),
    and a JPEG raises naming the file."""
    data = make_valparity_dataset(tmp_path / "d", nc=1, n=4, imgsz=64)
    cv2.imwrite(str(tmp_path / "photo.jpg"), np.zeros((16, 16, 3), np.uint8))
    code = f"""
import sys
sys.modules["cv2"] = None
sys.modules["PIL"] = None
import improving_yolov8_cbam_swinblock_tpu_torch
from improving_yolov8_cbam_swinblock_tpu_torch.data.dataset import DataLoader, YOLODataset, check_det_dataset
from improving_yolov8_cbam_swinblock_tpu_torch.utils.patches import _decoder, imread
info = check_det_dataset({str(data)!r})
ds = YOLODataset(info["val"], imgsz=64, max_gt=8, nc=1)
tb = next(iter(DataLoader(ds, 2, train=True, workers=2)))
hyp = {{"mixup": 1.0, "mosaic9": 0.5, "degrees": 10.0, "perspective": 1e-3, "pixel_augment": 1.0}}
hb = next(iter(DataLoader(ds, 2, train=True, workers=2, device_augment=False, hyp=hyp)))
vb = next(iter(DataLoader(ds, 2, train=False, workers=2)))
try:
    imread({str(tmp_path / "photo.jpg")!r})
    raised = ""
except RuntimeError as e:
    raised = str(e)
print(_decoder(), tb["img"].shape, hb["img"].shape, "aug" in hb, vb["img"].shape, int(vb["mask"].sum()) > 0,
      "photo.jpg" in raised, sys.modules["cv2"], sys.modules["PIL"])
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["png", "(2,", "64,", "64,", "3)", "(2,", "64,", "64,", "3)", "False", "(2,", "64,",
                                  "64,", "3)", "True", "True", "None", "None"], out.stdout
