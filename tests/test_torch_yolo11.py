"""The fork's YOLO11 graph in the port vs the JAX package, on the same weights.

Module level (fp32, tolerance 1e-5: the same math, summed in another
order): C3k2 with c3k off and on, C2PSA (multi-head position-sensitive
attention) and Detect with legacy=False, each in eval mode and in train mode,
where the BatchNorms normalise by the batch and move their running
statistics (flax's apply(..., mutable=["batch_stats"])). Graph level:
yolo11n-cbam-swin (scale n, both C3k2 branches) at 64 px, unfused and
BN-folded, within 2e-3 as the flagship's test holds it. The weight bridge
loads every yolo11m-cbam-swin name strictly. The JAX modules run under
one jax.jit together, eval and train mode in the same one (a fifth of
their eager time on the CPU), the graph under one jax.jit for the module.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn import modules as JM
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import randomize, seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-5
GRAPH_TOL = 2e-3
CFG = "yolo11n-cbam-swin.yaml"


def seeded_module(jmod, xs, rng):
    """A JAX module's variables from its abstract init (no compile): kernels
    uniform with the JAX package's conv init variance 1/(3 fan_in), then
    randomize()'s norms, biases and statistics."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), xs))

    def leaf(s):
        if s.ndim < 2:
            return np.zeros(s.shape, np.float32)
        bound = np.sqrt(1.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return randomize(jax.tree.map(leaf, shapes), rng)


def to_torch(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)  # NHWC -> NCHW, channels_last


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * max(1.0, float(np.abs(ref).max())))


def module_case(name):
    """(JAX module, port module, inputs as NHWC numpy arrays) of one case."""
    rng = np.random.default_rng(7)
    if name.startswith("c3k2"):
        c3k = name == "c3k2_c3k"
        jm, pm = JM.C3k2(32, n=2, c3k=c3k, e=0.5), M.C3k2(24, 32, n=2, c3k=c3k, e=0.5)
        xs = rng.normal(0, 1, (2, 9, 8, 24)).astype(np.float32)
    elif name == "c2psa":
        jm, pm = JM.C2PSA(256, n=1), M.C2PSA(192, 256, n=1)  # c 128: 2 heads of 64, key dim 32
        xs = rng.normal(0, 1, (2, 6, 5, 192)).astype(np.float32)
    else:
        ch = (16, 32, 64)
        jm, pm = JM.Detect(nc=3, ch=ch, legacy=False), M.Detect(3, ch, legacy=False)
        xs = [rng.normal(0, 1, (2, 8 // 2**i, 8 // 2**i, c)).astype(np.float32) for i, c in enumerate(ch)]
    v = seeded_module(jm, xs if isinstance(xs, list) else jnp.asarray(xs), rng)
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, pm.to(memory_format=torch.channels_last), v, xs


MODULE_CASES = ("c3k2", "c3k2_c3k", "c2psa", "detect")


@functools.cache
def jax_module_refs():
    """{(name, train): JAX's output (and in training its moved batch_stats)} of
    every module case, eval and train mode, all under one jax.jit."""
    cases = {name: module_case(name) for name in MODULE_CASES}

    def run(vs, xs):
        out = {}
        for name, (jm, _, _, _) in cases.items():
            out[f"{name}/eval"] = jm.apply(vs[name], xs[name], train=False)
            out[f"{name}/train"] = jm.apply(vs[name], xs[name], train=True, mutable=["batch_stats"])
        return out

    jx = {n: [jnp.asarray(x) for x in c[3]] if isinstance(c[3], list) else jnp.asarray(c[3]) for n, c in cases.items()}
    return jax.jit(run)({n: c[2] for n, c in cases.items()}, jx)


@pytest.mark.parametrize("name", MODULE_CASES)
@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax(name, train):
    jm, pm, v, xs = module_case(name)
    tx = [to_torch(x) for x in xs] if isinstance(xs, list) else to_torch(xs)
    pm.train(train)
    if train:
        ref, moved = jax_module_refs()[f"{name}/train"]
    else:
        ref = jax_module_refs()[f"{name}/eval"]
    with torch.no_grad():
        out = pm(tx)
    if name == "detect":
        if train:  # the raw maps
            for f, rf in zip(out, ref):
                close(nhwc(f), rf, MOD_TOL)
        else:  # decoded (B, 4 + nc, A) and the raw maps
            close(out[0].numpy(), ref[0], MOD_TOL)
            for f, rf in zip(out[1], ref[1]):
                close(nhwc(f), rf, MOD_TOL)
    else:
        close(nhwc(out), ref, MOD_TOL)
    if train:
        want = state_dict_from_jax({"batch_stats": jax.tree.map(np.asarray, moved["batch_stats"])})
        got = pm.state_dict()
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            close(got[k].numpy(), want[k].numpy(), MOD_TOL)


def test_detect_legacy_false_names_the_reference_cls_branch():
    """YOLO11's cls branch: DWConv 3x3 -> Conv 1x1, twice, then the 1x1 conv
    (names cv3.i.0.0 .. cv3.i.2); the depth-wise convs have one group per channel."""
    d = M.Detect(1, (64, 128, 256), legacy=False)
    names = {k for k in d.state_dict() if k.startswith("cv3.0.")}
    assert {"cv3.0.0.0.conv.weight", "cv3.0.0.1.conv.weight", "cv3.0.1.0.conv.weight", "cv3.0.1.1.bn.running_var",
            "cv3.0.2.weight", "cv3.0.2.bias"} <= names
    assert d.cv3[0][0][0].conv.groups == 64 and d.cv3[0][1][0].conv.groups == 64  # c3 = max(64, nc)


@pytest.fixture(scope="module")
def yolo11n():
    jm = JaxDetectionModel(CFG)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(CFG, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    fwd = jax.jit(lambda vv, x: jm.apply(vv, x, train=False))
    return jm, v, pm, fwd


@pytest.mark.parametrize("fused", [False, True])
def test_yolo11n_matches_jax(yolo11n, fused):
    jm, v, pm, fwd = yolo11n
    x = np.random.default_rng(64).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    if fused:
        v = fuse_variables(v)
        pm = copy.deepcopy(pm).fuse()
    ref, ref_feats = fwd(v, jnp.asarray(x))
    ref = np.asarray(ref)
    with torch.no_grad():
        out, feats = pm(to_torch(x))
    out = out.numpy()
    assert out.shape == ref.shape == (2, 5, 64 + 16 + 4)
    np.testing.assert_allclose(out[:, :4], ref[:, :4], rtol=GRAPH_TOL, atol=GRAPH_TOL * np.abs(ref[:, :4]).max())
    np.testing.assert_allclose(out[:, 4:], ref[:, 4:], rtol=GRAPH_TOL, atol=GRAPH_TOL)
    for f, rf in zip(feats, ref_feats):
        np.testing.assert_allclose(nhwc(f), np.asarray(rf), rtol=GRAPH_TOL, atol=GRAPH_TOL)


def test_yolo11n_ckpt_bridge_matches_jax(yolo11n, tmp_path):
    """The .ckpt that JAX YOLO.save writes for yolo11n-cbam-swin, read by the
    port's YOLO(ckpt) and its Backend: both forwards against JAX's on the
    variables written (uint8 frames / 255, as the Backend feeds them)."""
    from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
    from improving_yolov8_cbam_swinblock_tpu_torch import YOLO
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend

    _, v, _, fwd = yolo11n
    jy = JaxYOLO(CFG)
    jy.variables = v
    jy.save(str(tmp_path / "y11.ckpt"))
    img = np.random.default_rng(11).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    ref = np.asarray(fwd(v, jnp.asarray(img.astype(np.float32) / 255))[0])
    with torch.no_grad():
        out = YOLO(str(tmp_path / "y11.ckpt"), device="cpu").model(to_torch(img.astype(np.float32) / 255))[0].numpy()
    be = Backend(str(tmp_path / "y11.ckpt"), device="cpu")
    assert be.format == "ckpt" and be.nc == 1
    for got in (out, be(img)):
        assert got.shape == ref.shape == (2, 5, 84)
        np.testing.assert_allclose(got[:, :4], ref[:, :4], rtol=GRAPH_TOL, atol=GRAPH_TOL * np.abs(ref[:, :4]).max())
        np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=GRAPH_TOL, atol=GRAPH_TOL)


def test_yolo11n_builds_both_c3k2_branches_and_yolo11_head(yolo11n):
    pm = yolo11n[2]
    kinds = {type(m.m[0]).__name__ for m in pm.model if isinstance(m, M.C3k2)}
    assert kinds == {"Bottleneck", "C3k"}
    assert [m.i for m in pm.model if isinstance(m, M.SwinBlock)] == [7, 17]
    assert [type(m).__name__ for m in pm.model if isinstance(m, (M.C2PSA, M.CBAM))] == ["CBAM", "C2PSA", "C2PSA"]
    assert isinstance(pm.model[-1].cv3[0][0], torch.nn.Sequential)


def test_weight_bridge_strict_yolo11m():
    """Every leaf of yolo11m-cbam-swin's JAX variables names one port tensor
    of the same shape and the port has no other (strict load); scale m forces
    c3k and builds its Swin blocks at C=512."""
    shapes = JaxDetectionModel("yolo11m-cbam-swin.yaml").shape_init(imgsz=64)
    state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    pm = DetectionModel("yolo11m-cbam-swin.yaml", device="cpu")
    own = pm.state_dict()
    assert state.keys() == own.keys()
    assert all(state[k].shape == own[k].shape for k in own)
    pm.load_state_dict(state, strict=True)
    assert pm.meta["scale"] == "m" and all(m.norm1.weight.numel() == 512 for m in pm.model
                                           if isinstance(m, M.SwinBlock))
    assert all(isinstance(m.m[0], M.C3k) for m in pm.model if isinstance(m, M.C3k2))
    assert {"model.12.m.0.attn.qkv.conv.weight", "model.12.m.0.attn.pe.conv.weight", "model.12.m.0.ffn.1.bn.bias",
            "model.6.m.0.m.1.cv2.conv.weight", "model.27.cv3.2.1.0.conv.weight"} <= set(own)


def test_quantize_model_takes_the_yolo11_graph():
    """quantize_model takes yolo11n: every Conv gets its quant buffers, and
    exactly its 80 ungrouped convs run int8; the 8 grouped ones (C2PSA's
    `pe`, Detect's depth-wise convs) keep their float path, as the JAX
    package's Conv gates its int8 branch on g == 1. The int8 model predicts."""
    m = DetectionModel(CFG, device="cpu", param_dtype=torch.float32).fuse()
    frames = np.random.default_rng(3).integers(0, 256, (2, 1, 64, 64, 3), dtype=np.uint8)
    quantize_model(m, list(frames))
    convs = {n: c for n, c in m.named_modules() if isinstance(c, M.Conv)}
    assert len(convs) == 88 and all(c.w_int8 is not None for c in convs.values())
    grouped = sorted(n for n, c in convs.items() if c.conv.groups > 1)
    assert sum(c.runs_int8 for c in convs.values()) == 80 and len(grouped) == 8
    assert not any(convs[n].runs_int8 for n in grouped)
    assert {"model.12.m.0.attn.pe", "model.13.m.0.attn.pe", "model.27.cv3.0.0.0", "model.27.cv3.2.1.0"} <= set(grouped)
    with torch.no_grad():
        out, _ = m(torch.from_numpy(frames[0]).permute(0, 3, 1, 2).float() / 255)
    assert out.shape == (1, 5, 84) and torch.isfinite(out).all()
