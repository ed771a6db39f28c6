"""The whole flagship graph of the port vs the JAX package's, on the same weights.

yolov8n-cbam-swin (scale n) gets seeded numpy values for the JAX
variables' shapes (kernels, norms, biases, BN statistics), carried into the
port through the weight bridge (strict load), and both run the same numpy images in fp32: the
decoded (B, 5, A) output and the three raw maps, unfused and BN-folded.
Tolerance rtol/atol 2e-3 (atol scaled by the largest box coordinate): the
same fp32 math, summed in another order through ~60 layers.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.ops.quant import is_quantized
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
TOL = 2e-3


def randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out[k] = randomize(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, np.shape(v)).astype(np.float32)
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0, 0.1, np.shape(v)).astype(np.float32)
        else:
            out[k] = np.asarray(v, np.float32)
    return out


def seeded_variables(jm, imgsz, rng):
    """The JAX model's variables without running its init (which compiles the
    whole graph): kernels uniform with the JAX package's conv init variance
    1/(3 fan_in), then randomize()."""
    def leaf(s):
        if s.ndim < 2:
            return np.zeros(s.shape, np.float32)
        bound = np.sqrt(1.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return randomize(jax.tree.map(leaf, jm.shape_init(imgsz=imgsz)), rng)


@pytest.fixture(scope="module")
def flagship():
    jm = JaxDetectionModel(CFG)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(CFG, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    fwd = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))
    return jm, v, pm, fwd


def run_both(flagship, imgsz, fused):
    jm, v, pm, fwd = flagship
    x = np.random.default_rng(imgsz).uniform(0, 1, (2, imgsz, imgsz, 3)).astype(np.float32)
    if fused:
        v = fuse_variables(v)
        pm = copy.deepcopy(pm).fuse()
    ref, ref_feats = fwd(v, jnp.asarray(x))
    with torch.no_grad():
        out, feats = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    return np.asarray(ref), [np.asarray(f) for f in ref_feats], out.numpy(), [f.permute(0, 2, 3, 1).numpy() for f in feats]


@pytest.mark.parametrize("imgsz", [96, 160])
@pytest.mark.parametrize("fused", [False, True])
def test_flagship_matches_jax(flagship, imgsz, fused):
    ref, ref_feats, out, feats = run_both(flagship, imgsz, fused)
    a = imgsz // 8
    assert out.shape == ref.shape == (2, 5, a * a + a * a // 4 + a * a // 16)
    np.testing.assert_allclose(out[:, :4], ref[:, :4], rtol=TOL, atol=TOL * np.abs(ref[:, :4]).max())
    np.testing.assert_allclose(out[:, 4:], ref[:, 4:], rtol=TOL, atol=TOL)
    for f, rf in zip(feats, ref_feats):
        np.testing.assert_allclose(f, rf, rtol=TOL, atol=TOL)


def test_flagship_runs_plain_swin_on_cpu(flagship):
    """On the CPU both Swin sites take the plain version: no kernel launch."""
    before = S.swin_block_cuda.launches
    run_both(flagship, 96, False)
    assert S.swin_block_cuda.launches == before
    swins = [m for m in flagship[2].model if isinstance(m, type(flagship[2].model[7]))]
    assert [m.i for m in swins] == [7, 16]


@pytest.mark.parametrize("cfg,params", [("yolov8n-cbam-swin.yaml", 3_580_469), ("yolov8s-cbam-swin.yaml", 13_405_253)])
def test_weight_bridge_strict_334_names(cfg, params):
    """Every JAX leaf names one port tensor and the port has no other: 334
    names at scales n and s (plus BatchNorm's num_batches_tracked)."""
    shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)
    v = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = state_dict_from_jax(v)
    named = [k for k in state if not k.endswith("num_batches_tracked")]
    assert len(named) == 334
    pm = DetectionModel(cfg, device="cpu")
    pm.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in pm.parameters()) == params
    assert {"model.7.attn.in_proj_weight", "model.7.attn.out_proj.weight", "model.7.norm1.weight",
            "model.7.mlp.0.weight", "model.7.mlp.2.weight", "model.10.ca.shared_MLP.0.weight",
            "model.10.sa.conv.weight", "model.26.cv2.0.0.conv.weight", "model.26.cv2.0.2.bias",
            "model.16.attn.in_proj_bias", "model.2.m.0.cv1.bn.running_mean"} <= set(named)
    assert state["model.7.attn.in_proj_weight"].shape == (3 * pm.model[7].norm1.weight.numel(),
                                                           pm.model[7].norm1.weight.numel())


def test_weight_bridge_refuses_fused_variables(flagship):
    with pytest.raises(ValueError, match="fused"):
        state_dict_from_jax(fuse_variables(flagship[1]))


def test_save_and_load_roundtrip(flagship, tmp_path):
    jm, v, pm, fwd = flagship
    y = YOLO(CFG, device="cpu").load_jax_variables(v)
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    for fused in (False, True):
        if fused:
            y.fuse()
        y.save(tmp_path / "m.pt")
        y2 = YOLO(str(tmp_path / "m.pt"), device="cpu")
        assert y2.is_fused == fused
        with torch.no_grad():
            assert torch.equal(y.model(x)[0], y2.model(x)[0])


def test_save_keeps_fp32_masters_of_a_bf16_model(tmp_path):
    """A bf16-compute model with fp32 master weights reloads with every
    parameter and buffer in its dtype and bit for bit, unfused and fused, and
    quantize_model takes the reloaded fused model. A file without the
    param_dtype key loads its matrices in the compute dtype."""
    y = YOLO(CFG, device="cpu", dtype=torch.bfloat16, param_dtype=torch.float32)
    for fused in (False, True):
        if fused:
            y.fuse()
        y.save(tmp_path / "m.pt")
        y2 = YOLO(str(tmp_path / "m.pt"), device="cpu")
        a, b = y.model.state_dict(), y2.model.state_dict()
        assert y2.is_fused == fused and y2.model.dtype == torch.bfloat16 and a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert y2.model.model[7].attn.in_proj_weight.dtype == torch.float32
    frame = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    quantize_model(y2.model, [frame])
    assert is_quantized(y2.model)
    payload = torch.load(tmp_path / "m.pt", weights_only=True)
    del payload["param_dtype"]
    torch.save(payload, tmp_path / "old.pt")
    old = YOLO(str(tmp_path / "old.pt"), device="cpu")
    assert old.model.model[7].attn.in_proj_weight.dtype == torch.bfloat16


def test_model_strides_scale_and_dtype():
    m = DetectionModel("yolov8s-cbam-swin.yaml", device="cpu", dtype=torch.bfloat16)
    assert m.meta["scale"] == "s" and m.strides == (8, 16, 32) and m.nc == 1
    swin = m.model[7]
    assert swin.attn.in_proj_weight.dtype == torch.bfloat16 and swin.norm1.weight.dtype == torch.float32
    assert swin.attn.in_proj_bias.dtype == torch.float32 and m.model[0].bn.weight.dtype == torch.float32
    assert m.model[0].conv.weight.dtype == torch.bfloat16
    assert m.model[0].conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert swin.norm1.weight.numel() == 256  # the flagship's Swin width at scale s


def test_seeded_init_is_reproducible():
    a = DetectionModel(CFG, device="cpu", seed=3).state_dict()
    b = DetectionModel(CFG, device="cpu", seed=3).state_dict()
    c = DetectionModel(CFG, device="cpu", seed=4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.7.attn.in_proj_weight"], c["model.7.attn.in_proj_weight"])
