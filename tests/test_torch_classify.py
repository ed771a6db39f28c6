"""Image classification in the port vs the JAX package, on the same weights and inputs.

Graphs: all six `*-cls*` YAMLs (yolov8-cls, yolov8-cls-resnet50 and
-resnet101 of ResNetLayer rows, yolo11-cls, yolo11-cls-resnet18's native
TorchVision trunk, yolo12-cls) build in the port, and every parameter and
statistic name and shape equals JAX's abstract trace (shape_init: no
compile; a strict load on the meta device). yolov8n-cls, yolo11n-cls and
yolo11-cls-resnet18 at 64 px (nc 10) on seeded JAX variables bridged into
the port: the eval softmax, unfused and BN-folded by the port (and from
JAX's BN-folded tree for resnet18), the train-mode logits and the moved
BatchNorm statistics, within GRAPH_TOL (of the largest magnitude: up to
~60 fp32 layers summed in another order), one jax.jit a graph (compiled at
XLA's backend optimization level 0); the weight bridge both ways, bit for
bit, on those three and on resnet50 and yolo12n-cls; the .ckpt and .pt
round trips; an ensemble refuses a classify member.

Head: Dropout is the identity in eval and at rate 0, and in training keeps
about 1 - p of the elements, each scaled by 1 / (1 - p), from a seeded
torch.Generator (the same seed, the same mask). Predict: the port's probs
on 64 px frames within GRAPH_TOL of JAX's forward, and Results.probs's
top1, top5, verbose() and summary() equal the JAX predictor's
_run_classify_batch on them. Validator: JAX's hand-made top-k fixture gives
the same top1 and top5 (fitness (top1 + top5) / 2 where JAX's validator
says top1: ROADMAP Queue 3), and on yolov8n-cls's seeded weights over an
image folder of 64 px images the port's top1 and top5 equal JAX's
ClassificationValidator's, the wrapped last batch counted as JAX counts
it. int8: the convs quantize_model calibrates are JAX's calibration pass's
(Classify's linear stays float), and yolov8n-cls's int8 softmax with JAX's
quant state carried in within OUT_TOL of JAX's int8 forward
(tests/int8_parity.py); a .pt2 program (static and dynamic batch) served by
YOLO(path) equals the live model's probs bit for bit, its sidecar says
task classify, and nms=True raises.
"""

import copy
import functools
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.engine import validator as JV
from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.data.classify import ClassificationDataset as JaxDataset
from improving_yolov8_cbam_swinblock_tpu.data.classify import ClassificationLoader as JaxLoader
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data.classify import ClassificationDataset, ClassificationLoader
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import ClassificationValidator
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from tests.int8_parity import (EXACT, assert_out_close, int8_with_jax_state, jax_int8, port_int8,
                               to_port_calib)
from tests.test_torch_model import seeded_variables
from tests.test_torch_yolo11 import close, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
GRAPH_TOL = 2e-3
NC = 10
QUICK = {"xla_backend_optimization_level": 0}
GRAPHS = ("yolov8n-cls.yaml", "yolo11n-cls.yaml", "yolo11-cls-resnet18.yaml")
ALL_GRAPHS = ("yolov8n-cls.yaml", "yolov8-cls-resnet50.yaml", "yolov8-cls-resnet101.yaml", "yolo11n-cls.yaml",
              "yolo11-cls-resnet18.yaml", "yolo12n-cls.yaml")
FRAMES = np.random.default_rng(21).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)  # RGB


def cfg_nc(cfg, nc=NC):
    d = yaml_model_load(cfg)
    d["nc"] = nc
    return d


def flat(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.cache
def graph(cfg):
    """(JAX model, seeded JAX variables, the port model loaded strictly, and
    JAX's outputs on FRAMES: the eval softmax, the train logits and the
    moved batch_stats), one jax.jit."""
    jm = JaxDetectionModel(cfg, nc=NC)
    v = seeded_variables(jm, 64, np.random.default_rng(3))
    pm = DetectionModel(cfg_nc(cfg), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm, forward(jm, v, FRAMES)


def forward(jm, v, frames):
    def run(vv, img):
        x = img.astype(jnp.float32) / 255.0
        logits, moved = jm.apply(vv, x, train=True, mutable=["batch_stats"])
        return jm.apply(vv, x, train=False), logits, moved["batch_stats"]

    img = jnp.asarray(frames)
    return jax.tree.map(np.asarray, jax.jit(run).lower(v, img).compile(compiler_options=QUICK)(v, img))


@pytest.mark.parametrize("cfg", ALL_GRAPHS)
def test_names_and_shapes_equal_jax(cfg):
    """Every leaf of JAX's abstract variables names one port tensor of its
    shape and the port has no other (strict, on the meta device); the task
    is classify and the graph has no strides."""
    shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                             {k: shapes[k] for k in ("params", "batch_stats")}))
    pm.load_state_dict(state, strict=True, assign=True)
    assert pm.task == "classify" and pm.strides == () and isinstance(pm.model[-1], M.Classify)
    assert all(tuple(state[k].shape) == tuple(t.shape) for k, t in pm.state_dict().items())
    if "resnet" in cfg:  # ResNetLayer and TorchVision rows are never width-scaled
        assert pm.model[-1].conv.conv.in_channels in (512, 2048)


@pytest.mark.parametrize("cfg,how", [(c, h) for c in GRAPHS for h in ("unfused", "port_fuse", "jax_folded_tree")
                                      if h != "jax_folded_tree" or "resnet" in c])
def test_graph_eval_matches_jax(cfg, how):
    """Eval mode: the (B, nc) fp32 softmax within GRAPH_TOL; the port's
    fuse() and JAX's fuse_variables tree (fused_state_from_jax) equal each other."""
    _, v, pm, (ref, _, _) = graph(cfg)
    if how == "port_fuse":
        pm = copy.deepcopy(pm).fuse()
        assert pm.is_fused
    elif how == "jax_folded_tree":
        own = copy.deepcopy(pm).fuse()
        pm = DetectionModel(cfg_nc(cfg), device="cpu").fuse()
        pm.load_state_dict(fused_state_from_jax(jax.tree.map(np.asarray, fuse_variables(v))), strict=True)
        for k, t in own.state_dict().items():
            close(pm.state_dict()[k].numpy(), t.numpy(), 1e-6)
    with torch.no_grad():
        probs = pm(to_torch(FRAMES.astype(np.float32) / 255.0))
    assert probs.dtype == torch.float32 and probs.shape == ref.shape == (2, NC)
    close(probs.numpy(), ref, GRAPH_TOL)
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("cfg", GRAPHS)
def test_graph_train_matches_jax(cfg):
    """Train mode: the (B, nc) logits and every moved BatchNorm statistic
    within GRAPH_TOL of JAX's (flax's biased variance, momentum 0.97)."""
    _, _, pm0, (_, ref_logits, moved) = graph(cfg)
    pm = copy.deepcopy(pm0).train()
    with torch.no_grad():
        logits = pm(to_torch(FRAMES.astype(np.float32) / 255.0))
    assert logits.shape == ref_logits.shape == (2, NC)
    close(logits.numpy(), ref_logits, GRAPH_TOL)
    want = state_dict_from_jax({"batch_stats": moved})
    got = pm.state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    for k in stats:
        close(got[k].numpy(), want[k].numpy(), GRAPH_TOL)


@pytest.mark.parametrize("cfg", [*GRAPHS, "yolov8-cls-resnet50.yaml", "yolo12n-cls.yaml"])
def test_bridge_both_ways(cfg):
    """ResNetLayer's layer_0 and a block's shortcut_0 as layer.0 and
    shortcut.0, TorchVision's stem and layer1_0 as stem and layer1.0, the
    head's Dense as linear (kernel (in, out) <-> weight (out, in)); the state
    written back is JAX's tree, bit for bit."""
    if cfg in GRAPHS:
        _, v, pm, _ = graph(cfg)
    else:
        jm = JaxDetectionModel(cfg, nc=NC)
        v = seeded_variables(jm, 64, np.random.default_rng(5))
        pm = DetectionModel(cfg_nc(cfg), device="cpu")
        pm.load_state_dict(state_dict_from_jax(v), strict=True)
    head = f"model.{len(pm.model) - 1}"
    names = set(pm.state_dict())
    assert {f"{head}.linear.weight", f"{head}.linear.bias", f"{head}.conv.conv.weight"} <= names
    kernel = v["params"][f"model_{len(pm.model) - 1}"]["linear"]["kernel"]
    np.testing.assert_array_equal(pm.state_dict()[f"{head}.linear.weight"].numpy(), kernel.T)
    if "resnet50" in cfg:
        assert {"model.1.layer.0.shortcut.0.conv.weight", "model.0.layer.0.conv.weight",
                "model.4.layer.2.cv3.bn.running_var"} <= names
    if "resnet18" in cfg:
        assert {"model.0.stem.layer.0.conv.weight", "model.0.layer1.1.cv2.bn.weight",
                "model.0.layer2.0.shortcut.0.conv.weight", "model.0.layer4.1.cv1.conv.weight"} <= names
    back = jax_variables_from_state(pm)
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(back)
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)


def test_ckpt_and_pt_round_trips_and_ensemble_refuses_classify(tmp_path):
    """YOLO.save of yolo11-cls-resnet18 as a JAX-format .ckpt and as a .pt,
    each read back by YOLO(path): task classify, the same state bit for bit;
    an ensemble with a classify member is refused."""
    y = YOLO(cfg_nc(GRAPHS[2]), device="cpu")
    y.model.load_state_dict(graph(GRAPHS[2])[2].state_dict())
    for name in ("m.ckpt", "m.pt"):
        y.save(str(tmp_path / name))
        back = YOLO(str(tmp_path / name), device="cpu")
        assert back.task == "classify" and back.model.nc == NC
        want = y.model.state_dict()
        assert all(torch.equal(t, want[k]) for k, t in back.model.state_dict().items())
    with pytest.raises(ValueError, match="classify member"):
        EnsembleModel([DetectionModel(cfg_nc("yolov8n.yaml"), device="cpu"), y.model])


def test_torchvision_gates_raise_as_jax():
    for kw, match in (({"model": "vgg16"}, "not supported natively"), ({"split": True}, "split=True"),
                      ({"truncate": 1}, "feature-trunk form")):
        with pytest.raises(NotImplementedError, match=match):
            M.TorchVision(3, **kw)


# ---------------------------------------------------------------------------------------------------------------
# the head's dropout


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5])
def test_dropout_eval_identity_and_train_rate(p):
    """Eval, and rate 0: the identity. Training: the kept fraction within
    0.01 of 1 - p over 40,000 draws, each kept element x / (1 - p), the rest
    0 (flax's nn.Dropout); the same seed draws the same mask."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(0.5, 1.5, (40, 1000)).astype(np.float32))
    d = M.Dropout(p)
    assert torch.equal(d.eval()(x), x)
    d.train()
    d.generator = torch.Generator().manual_seed(7)
    y = d(x)
    if p == 0.0:
        assert torch.equal(y, x)
        return
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(d(x), y)


# ---------------------------------------------------------------------------------------------------------------
# predict and Results


def test_predict_probs_and_results_match_jax():
    """The port's predictor on the two frames (BGR, 64 x 64: the resize to
    imgsz is the identity in both packages): probs within GRAPH_TOL of JAX's
    forward; top1, top5, verbose() and summary() equal the JAX predictor's
    _run_classify_batch (its forward replaced by the same JAX output)."""
    jm, _, pm, (ref, _, _) = graph(GRAPHS[0])
    names = {i: f"class{i}" for i in range(NC)}
    frames = [(np.ascontiguousarray(f[..., ::-1]), f"f{i}") for i, f in enumerate(FRAMES)]
    pm = copy.deepcopy(pm).fuse()
    pm.names = names
    got = DetectionPredictor(pm, get_cfg({"verbose": False}))(np.stack([f for f, _ in frames]), imgsz=64)
    jp = JaxPredictor(SimpleNamespace(task="classify", names=names, dtype=jnp.float32),
                      SimpleNamespace(verbose=False))
    jp._get_fn = lambda shape: (lambda variables, img: (ref, None))
    want = jp._run_classify_batch({}, frames, 64)
    for g, w in zip(got, want):
        close(g.probs.data, w.probs.data, GRAPH_TOL)
        assert g.probs.top1 == w.probs.top1 and g.probs.top5 == w.probs.top5
        assert len(g) == len(w) == 0 and g.boxes.data.shape == (0, 6)
        same = type(g).update(g.new(), probs=w.probs.data)  # the port's Results on JAX's probs
        assert same.verbose() == w.verbose() and same.summary() == w.summary()
        assert same.probs.top1conf == w.probs.top1conf
        np.testing.assert_array_equal(same.probs.top5conf, w.probs.top5conf)
        np.testing.assert_array_equal(same.plot(), w.plot())


def test_yolo_predict_classify_end_to_end():
    """YOLO(yolov8n-cls).predict of frames of other sizes: one Results each,
    probs summing to 1, top5 the five largest; a stream gives the same."""
    y = YOLO(cfg_nc(GRAPHS[0]), device="cpu")
    frames = [np.random.default_rng(i).integers(0, 256, (40 + 8 * i, 72, 3), dtype=np.uint8) for i in range(3)]
    res = y.predict(frames, imgsz=48, batch=2, verbose=False)
    assert [r.probs.data.shape for r in res] == [(NC,)] * 3
    for r in res:
        assert abs(r.probs.data.sum() - 1) < 1e-5 and r.masks is None and r.obb is None
        assert sorted(r.probs.data[r.probs.top5].tolist(), reverse=True) == sorted(r.probs.data)[::-1][:5]


# ---------------------------------------------------------------------------------------------------------------
# the validator


class _Fixed(torch.nn.Module):
    """A model whose eval forward gives fixed probabilities, one batch at a time."""

    def __init__(self, probs):
        super().__init__()
        self.probs = list(probs)
        self.dtype, self.nc, self.names = torch.float32, probs[0].shape[1], {}
        self.w = torch.nn.Parameter(torch.zeros(1))

    @property
    def device(self):
        return torch.device("cpu")

    def forward(self, x):
        return torch.from_numpy(self.probs.pop(0))


def test_validator_topk_fixture_and_fitness():
    """JAX's hand-made top-k fixture (tests/test_classify.py): top1 1/3, top5
    2/3 in both; the port's fitness is (top1 + top5) / 2 (ClassifyMetrics
    and the reference), JAX's validator's top1 (ROADMAP Queue 3)."""
    probs = np.array([[0.6, 0.2, 0.1, 0.05, 0.03, 0.02, 0.0, 0.0],
                      [0.3, 0.25, 0.2, 0.15, 0.05, 0.05, 0.0, 0.0],
                      [0.0, 0.05, 0.1, 0.15, 0.2, 0.1, 0.4, 0.0]], np.float32)
    batch = {"img": np.zeros((3, 8, 8, 3), np.uint8), "label": np.array([0, 4, 0])}
    jv = JV.ClassificationValidator.__new__(JV.ClassificationValidator)
    jv.model, jv.loader, jv.args = None, [batch], None
    jv._forward = lambda variables, img: probs
    ref = JV.ClassificationValidator.__call__(jv, {})
    got = ClassificationValidator(_Fixed([probs]), [batch], get_cfg({"verbose": False}))()
    assert got["top1"] == ref["top1"] == pytest.approx(1 / 3) and got["top5"] == ref["top5"] == pytest.approx(2 / 3)
    assert ref["fitness"] == ref["top1"] and got["fitness"] == pytest.approx(0.5)


@pytest.fixture(scope="module")
def val_folder(tmp_path_factory):
    """5 classes x 3 images of 64 x 64 (the resize is the identity in both packages): 15 images."""
    root = tmp_path_factory.mktemp("clsval")
    rng = np.random.default_rng(12)
    for c in range(5):
        (root / f"c{c}").mkdir()
        for i in range(3):
            cv2.imwrite(str(root / f"c{c}" / f"{i}.png"), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    return root


def test_validator_matches_jax_on_seeded_model(val_folder):
    """yolov8n-cls's seeded weights over the 15 images in batches of 2 (8
    batches, the last wrapping to the first image): the port's loader gives
    JAX's images and labels, and the port's ClassificationValidator JAX's
    top1 and top5 (JAX's validator running the same JAX forward); 16 images
    seen, as JAX counts them."""
    jm, v, pm, _ = graph(GRAPHS[0])
    jargs = jax_get_cfg(overrides={"imgsz": 64, "batch": 2, "verbose": False})
    jloader = JaxLoader(JaxDataset(val_folder, imgsz=64), 2, train=False, workers=1)
    ploader = ClassificationLoader(ClassificationDataset(val_folder, imgsz=64), 2, train=False, workers=1)
    for jb, pb in zip(jloader, ploader):
        np.testing.assert_array_equal(pb["img"], jb["img"])
        np.testing.assert_array_equal(pb["label"], jb["label"])
    jv = JV.ClassificationValidator(jm, jloader, jargs)
    fwd = jax.jit(lambda vv, img: jm.apply(vv, img.astype(jnp.float32) / 255.0, train=False))
    jv._forward = lambda variables, img: fwd(variables, img)
    ref = jv(v)
    pv = ClassificationValidator(pm, ploader, get_cfg({"imgsz": 64, "batch": 2, "verbose": False}))
    got = pv()
    assert got["top1"] == ref["top1"] and got["top5"] == ref["top5"] and pv.seen == 16
    assert got["fitness"] == pytest.approx((ref["top1"] + ref["top5"]) / 2)


def test_yolo_val_on_an_image_folder(val_folder, tmp_path):
    """YOLO.val(data=<folder>) reads <folder>/val (the JAX package's YOLO.val
    reads the folder as a data YAML: check_det_dataset raises
    IsADirectoryError, ROADMAP Queue 3): top1, top5, fitness and the
    reference's metrics/accuracy_top1 and _top5."""
    from improving_yolov8_cbam_swinblock_tpu.data.dataset import check_det_dataset as jax_check

    (tmp_path / "val").symlink_to(val_folder, target_is_directory=True)
    with pytest.raises(IsADirectoryError):
        jax_check(str(tmp_path))
    y = YOLO(cfg_nc(GRAPHS[0], 5), device="cpu")
    out = y.val(data=str(tmp_path), batch=4, imgsz=64, verbose=False)
    assert set(out) == {"top1", "top5", "fitness", "metrics/accuracy_top1", "metrics/accuracy_top5"}
    assert out.top5 == 1.0 and out["metrics/accuracy_top1"] == out.top1 and y.validator.seen == 16


# ---------------------------------------------------------------------------------------------------------------
# int8 and programs


@functools.cache
def int8_run():
    jm, v, pm, _ = graph(GRAPHS[0])
    return port_int8(pm, FRAMES), jax_int8(jm, v, FRAMES, FRAMES.astype(np.float32) / 255.0)


def test_int8_gate_matches_jax():
    """quantize_model on yolov8n-cls calibrates the convs JAX's calibration
    pass records (jax.eval_shape of it: no compile), Classify's conv among
    them and its linear left float; the int8 forward is a finite softmax."""
    jm, v, pm, (ref, _, _) = graph(GRAPHS[0])
    shapes = jax.eval_shape(lambda vv, x: jm.apply(vv, x, train=False, mutable=["calib"])[1]["calib"],
                            fuse_variables(v), jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = to_port_calib(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    m = copy.deepcopy(pm).fuse()
    got = Q.calibrate(m, [FRAMES])
    head = f"model.{len(pm.model) - 1}"
    assert got.keys() == want.keys() and f"{head}.conv" in got
    quantize_model(m, [FRAMES])
    assert all(c.runs_int8 for c in m.modules() if isinstance(c, M.Conv))
    assert m.model[-1].linear.weight.dtype == torch.float32 and not hasattr(m.model[-1].linear, "w_int8")
    with torch.no_grad():
        out = m(to_torch(FRAMES.astype(np.float32) / 255.0))
    assert out.shape == ref.shape and torch.isfinite(out).all()
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-6)


def test_int8_forward_matches_jax():
    """yolov8n-cls's BN-folded int8 graph with JAX's quant state carried in
    against JAX's int8 forward (compiled without excess precision): the
    softmax within OUT_TOL (tests/int8_parity.py)."""
    port, ref = int8_run()
    m = int8_with_jax_state(port, ref)
    with torch.no_grad():
        out = m(to_torch(FRAMES.astype(np.float32) / 255.0))
    assert_out_close(out.numpy(), ref["out"])
    assert EXACT["xla_allow_excess_precision"] is False


@pytest.mark.parametrize("dynamic", [False, True])
def test_program_round_trip(tmp_path, dynamic):
    """YOLO.export of yolo11-cls-resnet18 (static batch 2, or dynamic) served
    by YOLO(path): probs equal to the live BN-folded model's bit for bit at
    batch 2 (and 3 through the dynamic program); the sidecar says task
    classify, stride 1 and the softmax layout; nms=True raises."""
    y = YOLO(cfg_nc(GRAPHS[2]), device="cpu")
    y.model.load_state_dict(graph(GRAPHS[2])[2].state_dict())
    y.fuse()  # as predict serves it
    path = y.export(imgsz=64, batch=2, dynamic=dynamic, project=str(tmp_path))
    md = yaml.safe_load(open(f"{path}.yaml").read())
    assert md["task"] == "classify" and md["stride"] == 1 and "(B, nc)" in md["layout"]
    served = YOLO(path, device="cpu")
    frames = [np.ascontiguousarray(f[..., ::-1]) for f in FRAMES] + ([FRAMES[0][..., ::-1]] if dynamic else [])
    got = served.predict(frames, batch=len(frames), verbose=False)
    want = y.predict(frames, imgsz=64, batch=len(frames), verbose=False)
    assert served.task == "classify" and len(got) == len(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.probs.data, w.probs.data)
    if not dynamic:
        with pytest.raises(ValueError, match="detect-task"):
            y.export(imgsz=64, nms=True, project=str(tmp_path))
