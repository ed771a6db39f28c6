"""Test-time augmentation and ensembles of the port against the JAX package.

predict_augment runs the JAX package's three scales (1, 0.83 flipped,
0.67); at 224 px they pad to three different sizes (224, 192, 160), so the
resize, the bottom-right pad, the flip and the tail clipping all show. The
one JAX compile of this module is DetectionModel.predict_augment at 224
px, on yolov8n-cbam-swin with tests/test_torch_model.py's seeded variables,
in fp32: held at rtol 2e-3 with atol 2e-3 of the largest box coordinate
(the model test's tolerance: the same fp32 math, summed in another order,
through three forwards). The resize alone is held to jax.image.resize at
1e-5 (fp32 products of the same weights).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import TTA_RUNS, tta_resize
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
TOL = 2e-3


@pytest.fixture(scope="module")
def models():
    jm = JaxDetectionModel(CFG)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(CFG, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


@pytest.mark.parametrize("shape,size", [((2, 224, 224, 3), (185, 185)), ((2, 224, 224, 3), (150, 150)),
                                        ((1, 224, 160, 3), (185, 132)), ((1, 96, 128, 3), (64, 106))])
def test_tta_resize_matches_jax(shape, size):
    """The scaled copies of TTA (224 -> 185 and 150) and non-square ones,
    against jax.image.resize(method="linear"), which filters as it shrinks."""
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (shape[0], *size, 3), method="linear"))
    out = tta_resize(torch.from_numpy(x).permute(0, 3, 1, 2), *size).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_predict_augment_matches_jax(models):
    jm, v, pm = models
    x = np.random.default_rng(1).uniform(0, 1, (2, 224, 224, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jm.predict_augment)(v, jnp.asarray(x)))
    pads = [math.ceil(224 * s / 32) * 32 for s, _ in TTA_RUNS]
    assert pads == [224, 192, 160]
    seen = []
    hook = pm.model[7].register_forward_hook(lambda m, i, o: seen.append(tuple(o.shape[2:])))
    try:
        with torch.no_grad():
            out = pm.predict_augment(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    finally:
        hook.remove()
    assert seen == [(14, 14), (12, 12), (10, 10)]  # the P4 Swin site at the three scales
    a = [(p // 8) ** 2 + (p // 16) ** 2 + (p // 32) ** 2 for p in pads]
    assert out.shape == ref.shape == (2, 5, a[0] - (224 // 32) ** 2 + a[1] + a[2] - (160 // 8) ** 2)
    np.testing.assert_allclose(out[:, :4], ref[:, :4], rtol=TOL, atol=TOL * np.abs(ref[:, :4]).max())
    np.testing.assert_allclose(out[:, 4:], ref[:, 4:], rtol=TOL, atol=TOL)


def test_predict_with_augment_runs_three_forwards(models):
    """YOLO.predict(augment=True) runs predict_augment (three forwards per
    batch, the plain Swin version on the CPU: no kernel launch) and keeps
    the frame's geometry."""
    _, v, _ = models
    y = YOLO(CFG, device="cpu").load_jax_variables(v)
    calls = []
    hook = y.model.model[16].register_forward_hook(lambda m, i, o: calls.append(o.shape[0]))
    before = S.swin_block_cuda.launches
    try:
        res = y.predict([np.zeros((50, 70, 3), np.uint8)] * 3, imgsz=64, conf=0.001, batch=2, augment=True,
                        agnostic_nms=True, verbose=False)
    finally:
        hook.remove()
    assert calls == [2, 2, 2, 2, 2, 2] and S.swin_block_cuda.launches == before
    assert len(res) == 3 and all(r.orig_shape == (50, 70) for r in res)
    assert all((r.boxes.xyxy >= 0).all() and (r.boxes.xyxy[:, [0, 2]] <= 70).all() for r in res)


def test_ensemble_concatenates_its_members(models, tmp_path):
    """YOLO([a, b]): each member on the same input, their predictions
    concatenated along the anchors, exactly; one NMS over both."""
    _, v, pm = models
    YOLO(CFG, device="cpu").load_jax_variables(v).save(str(tmp_path / "a.ckpt"))
    YOLO(CFG, device="cpu", seed=1).save(str(tmp_path / "b.ckpt"))
    e = YOLO([str(tmp_path / "a.ckpt"), str(tmp_path / "b.ckpt")], device="cpu")
    assert isinstance(e.model, EnsembleModel) and e.model.strides == (8, 16, 32) and e.model.nc == 1
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        out, _ = e.model(x)
        parts = [m(x)[0] for m in e.model.members]
    assert torch.equal(out, torch.cat(parts, -1)) and out.shape == (2, 5, 2 * 84)
    res = e.predict([np.zeros((64, 64, 3), np.uint8)], imgsz=64, conf=0.001, verbose=False)
    assert e.is_fused and len(res) == 1 and len(res[0]) > 0
    with pytest.raises(NotImplementedError, match="augment"):
        e.predict(np.zeros((64, 64, 3), np.uint8), imgsz=64, augment=True)
    for call in (lambda: e.save(str(tmp_path / "e.ckpt")), lambda: e.train(data="x.yaml"), lambda: e.model.train()(x)):
        with pytest.raises(NotImplementedError, match="ensemble"):
            call()
    d = dict(pm.yaml, nc=3)
    YOLO(d, device="cpu").save(str(tmp_path / "c.ckpt"))
    with pytest.raises(ValueError, match="nc"):
        YOLO([str(tmp_path / "a.ckpt"), str(tmp_path / "c.ckpt")], device="cpu")
