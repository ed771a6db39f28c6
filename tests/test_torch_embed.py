"""Embeddings and feature maps of the port against the JAX package.

One module-scoped JAX model, yolov8n-cbam-swin at 64 px in fp32, with
tests/test_torch_model.py's seeded variables (no JAX init compile) carried
into the port through the weight bridge; one jax.jit runs JAX's
DetectionModel.embed for two layer lists and its DetectionModel.features.
The port's embed and features are held to them with rtol 1e-4 and atol
1e-5 (the same fp32 math summed in another order). feature_visualization
writes the same PNG as JAX's on one array, and PNGs within 1 level of
JAX's on the two models' features. The facade: predict(visualize=True)
writes one PNG per rank-4 layer per image under the JAX package's names,
and predict(embed=...) returns what YOLO.embed returns.
"""

from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.plotting import feature_visualization as jax_feature_visualization
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
from improving_yolov8_cbam_swinblock_tpu_torch.utils.plotting import feature_visualization
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
RTOL, ATOL = 1e-4, 1e-5
LAYERS = ((25,), (9, 15))


@pytest.fixture(scope="module")
def both():
    jm = JaxDetectionModel(CFG)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    meta = []

    def run(vv, xx):
        feats = jm.features(vv, xx)
        meta[:] = [(i, name) for i, name, _ in feats]  # static ints and names, recorded while tracing
        return [jm.embed(vv, xx, layers) for layers in LAYERS], [f for _, _, f in feats]

    embeds, feats = jax.jit(run)(v, jnp.asarray(x))
    y = YOLO(CFG, device="cpu").load_jax_variables(v)
    return SimpleNamespace(y=y, x=torch.from_numpy(x).permute(0, 3, 1, 2),
                           embeds=dict(zip(LAYERS, map(np.asarray, embeds))),
                           feats=[(i, name, np.asarray(f)) for (i, name), f in zip(meta, feats)])


@pytest.mark.parametrize("layers", LAYERS)
def test_embed_matches_jax(both, layers):
    with torch.no_grad():
        got = both.y.model.embed(both.x, layers).numpy()
        reordered = both.y.model.embed(both.x, layers[::-1]).numpy()
    ref = both.embeds[layers]
    assert got.shape == ref.shape == (2, {(25,): 256, (9, 15): 384}[layers])
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.array_equal(reordered, got)  # concatenated in row order, as JAX does


def test_features_match_jax(both):
    with torch.no_grad():
        feats = both.y.model.features(both.x)
    assert [(i, name) for i, name, _ in feats] == [(i, name) for i, name, _ in both.feats]
    assert [i for i, _, _ in feats] == list(range(26))
    for (i, _, f), (_, _, ref) in zip(feats, both.feats):
        np.testing.assert_allclose(f.permute(0, 2, 3, 1).numpy(), ref, rtol=RTOL, atol=ATOL, err_msg=f"layer {i}")
    with torch.no_grad():
        assert [i for i, _, _ in both.y.model.features(both.x, layers=(7, -2, 26))] == [7, 25]


def test_feature_visualization_matches_jax(both, tmp_path):
    """One array through both packages' writers: equal PNGs. The two models'
    features: PNGs within 1 level."""
    a = np.random.default_rng(2).normal(0, 1, (1, 9, 7, 40)).astype(np.float32)
    (tmp_path / "jax").mkdir()
    ref = jax_feature_visualization(a, "stage3_Conv", str(tmp_path / "jax"))
    got = feature_visualization(torch.from_numpy(a).permute(0, 3, 1, 2), "stage3_Conv", str(tmp_path))
    assert got == str(tmp_path / "stage3_Conv_features.png")
    assert open(got, "rb").read() == open(ref, "rb").read()
    assert cv2.imread(got, cv2.IMREAD_UNCHANGED).shape == (6 * 9, 6 * 7)  # 32 channels on a 6x6 grid
    assert feature_visualization(torch.zeros(2, 5), "x", str(tmp_path)) is None
    with torch.no_grad():
        feats = both.y.model.features(both.x)
    worst = 0
    for (i, name, f), (_, _, rf) in zip(feats, both.feats):
        got = cv2.imread(feature_visualization(f, f"stage{i}_{name}", str(tmp_path)), cv2.IMREAD_UNCHANGED)
        ref = cv2.imread(jax_feature_visualization(rf, f"stage{i}_{name}", str(tmp_path / "jax")),
                         cv2.IMREAD_UNCHANGED)
        assert got.shape == ref.shape
        worst = max(worst, int(np.abs(got.astype(int) - ref).max()))
    assert worst <= 1


def test_predict_visualize_and_embed(both, tmp_path):
    """The facade on two frames in memory: visualize writes the JAX names per
    image; predict(embed=...) is YOLO.embed; Detect cannot be embedded."""
    frames = np.random.default_rng(3).integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    y = both.y
    res = y.predict(frames, imgsz=64, conf=0.01, verbose=False, visualize=True, project=str(tmp_path), name="vis")
    assert len(res) == 2
    names = {f"stage{i}_{name}_features.png" for i, name, _ in both.feats}
    for stem in ("array[0]", "array[1]"):
        assert {p.name for p in (tmp_path / "vis" / stem).iterdir()} == names
    e = y.embed(frames, imgsz=64)
    assert e.dtype == np.float32 and e.shape == (2, 256)
    assert np.array_equal(y.predict(frames, embed=[25], imgsz=64), e)
    e2 = y.predict(frames, embed=[9, 15], imgsz=64)
    assert e2.shape == (2, 384) and np.array_equal(e2, y.embed(frames, layers=[9, 15], imgsz=64))
    for bad in ([26], [-1], [9, 26]):
        with pytest.raises(ValueError, match="layer 26 is Detect"):
            y.embed(frames, layers=bad, imgsz=64)
