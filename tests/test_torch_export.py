"""Export of the port (engine/exporter.py, nn/autobackend.py, utils/benchmarks.py) vs the JAX package's.

The flagship's blocks in nine rows (CFG: Conv, C2f, SwinBlock, CBAM, SPPF,
Detect) at 64 px with the JAX package's seeded variables
(tests/test_torch_model.py seeded_variables: no JAX init compile), fp32.
The port's torch.export program (`.pt2`), served by its Backend, is held to
the JAX Exporter's `stablehlo` artifact served by the JAX Backend, on the
same uint8 frames, at rtol 2e-2 and atol 2e-3 (the JAX package's own export
tolerance, tests/test_exports.py:54); the sidecars hold the same keys and
values but `layout` and `description`. A dynamic program serves batches 1
and 3, a static one refuses another batch; nms=True against the JAX
package's e2e_postprocess; the int8 program equals the port's live
quantized model bit for bit (the same operators; that model is held to JAX
by tests/test_torch_quant.py), at a static batch and, with dynamic=True, at
batches 1 and 3. Calibration and the class names fall back as the JAX
package's do where a data YAML cannot be read. The two SwinBlock operators pass
torch.library.opcheck on CPU tensors. The JAX side compiles the stablehlo
artifact at batches 1 and 3 and its Backend's checkpoint forward at batch 3.
A segmentation program returns the prediction and the prototypes, equal to
the live model's bit for bit, and YOLO(path).predict gives the live
model's boxes and masks; a YOLOv10 int8 program keeps the head's
(B, min(300, A), 6) detections, bit for bit with the live quantized model.
"""

import copy
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import yaml

from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
from improving_yolov8_cbam_swinblock_tpu.engine.exporter import Exporter as JaxExporter
from improving_yolov8_cbam_swinblock_tpu.nn.autobackend import Backend as JaxBackend
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.ops.nms import e2e_postprocess as jax_e2e_postprocess
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, EnsembleModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.engine.exporter import Exporter, export_formats
from improving_yolov8_cbam_swinblock_tpu_torch.nn.autobackend import Backend, check_class_names, default_class_names
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin as S
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8
from improving_yolov8_cbam_swinblock_tpu_torch.ops.nms import e2e_postprocess
from tests.synth_data import make_synth_dataset
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
# the flagship's blocks in nine rows (tests/test_torch_train.py COMPACT): P3 after row 3, a SwinBlock at P4, CBAM and
# an SPPF at P5; what the export cases test (the program, its operators, sidecar, batches and backends) does not
# depend on the graph's depth, and its JAX artifact compiles in a fraction of yolov8n-cbam-swin's time
CFG = {"nc": 1, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]], [-1, 1, "C2f", [32, True]],
                             [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "SwinBlock", [128]],
                             [-1, 1, "Conv", [128, 3, 2]], [-1, 1, "CBAM", []], [-1, 1, "SPPF", [128, 5]]],
       "head": [[[3, 5, 8], 1, "Detect", ["nc"]]]}
RTOL, ATOL = 2e-2, 2e-3
NAMES = {0: "person"}


def frames(b, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, 64, 64, 3), dtype=np.uint8)


def swin_ops(be):
    """The port's operators in the graph of a Backend's loaded program."""
    return sorted(str(n.target) for n in be._fn.graph.nodes if "yolov8_cbam_swin" in str(n.target))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The JAX model, its seeded variables and their .ckpt; the JAX
    stablehlo artifact (dynamic batch) and its Backend; the port's YOLO on
    the same variables and its dynamic pt2 program."""
    d = tmp_path_factory.mktemp("export")
    jm = JaxDetectionModel(copy.deepcopy(CFG))
    jm.names = dict(NAMES)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    jy = JaxYOLO(copy.deepcopy(CFG))
    jy.variables = v
    jy.model.names = dict(NAMES)
    jy.save(str(d / "jax.ckpt"))
    jpath = JaxExporter(jm, v, SimpleNamespace(format="stablehlo", imgsz=64, project=str(d / "jax"), dynamic=True))()
    y = YOLO(copy.deepcopy(CFG), device="cpu").load_jax_variables(v)
    y.model.names = dict(NAMES)
    path = y.export(imgsz=64, dynamic=True, project=str(d / "port"))
    return SimpleNamespace(d=d, jbe=JaxBackend(jpath), jpath=jpath, y=y, path=path, be=Backend(path, device="cpu"))


def test_pt2_matches_jax_stablehlo_at_any_batch(both):
    be = both.be
    assert be.format == "pt2" and swin_ops(be) == ["yolov8_cbam_swin.swin_block_fwd.default"]
    for b in (1, 3):
        img = frames(b, seed=b)
        out, ref = be(img), np.asarray(both.jbe(img))
        assert out.dtype == np.float32 and out.shape == ref.shape == (b, 5, 84)
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    mine = yaml.safe_load(open(f"{both.path}.yaml"))
    theirs = yaml.safe_load(open(f"{both.jpath}.yaml"))
    for md in (mine, theirs):
        del md["layout"], md["description"]
    assert mine == theirs and mine["batch"] == -1
    assert (be.names, be.stride, be.imgsz, be.task, be.nc, be.end2end) == (NAMES, 32, [64, 64], "detect", 1, False)


def test_pt2_equals_the_live_model_and_leaves_it_alone(both):
    before = {k: t.clone() for k, t in both.y.model.state_dict().items()}
    img = frames(3, seed=3)
    assert np.array_equal(both.be(img), Backend(both.y.model)(img))
    assert both.y.model.dtype == torch.float32 and not both.y.is_fused
    assert all(torch.equal(before[k], t) for k, t in both.y.model.state_dict().items())


def test_static_nms_program_refuses_another_batch(both, tmp_path):
    path = both.y.export(imgsz=64, batch=3, nms=True, max_det=50, project=str(tmp_path))
    be = Backend(path, device="cpu")
    assert path.endswith("model_64_nms.pt2") and be.end2end
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["batch"] == 3 and md["max_det"] == 50 and "xywh" in md["layout"]
    img = frames(3, seed=3)
    out = be(img)
    assert out.shape == (3, 50, 6)
    # the same top-k as JAX's on the same numbers (ties to the first index), and close to JAX's forward's
    live = Backend(both.y.model)(img)
    np.testing.assert_array_equal(out, np.asarray(jax_e2e_postprocess(live, 50, 1)))
    np.testing.assert_allclose(out, np.asarray(jax_e2e_postprocess(both.jbe(img), 50, 1)), rtol=RTOL, atol=ATOL)
    with pytest.raises(Exception):
        be(frames(2))


# a small detect graph for the int8 export: conv_int8 traces some 25 operators a conv, so the flagship's
# int8 program takes seconds to save and load on the CPU; its SwinBlock has one head of 128 (the int8 gate)
INT8_CFG = {"nc": 1, "backbone": [[-1, 1, "Conv", [32, 3, 2]], [-1, 1, "Conv", [64, 3, 2]],
                                  [-1, 1, "Conv", [64, 3, 2]], [-1, 1, "Conv", [128, 3, 2]],
                                  [-1, 1, "SwinBlock", [128, 1]], [-1, 1, "Conv", [128, 3, 2]]],
            "head": [[[2, 4, 5], 1, "Detect", ["nc"]]]}


def test_int8_program_equals_the_live_quantized_model(tmp_path, capsys):
    """The int8 block (K4's operator) is in the graph; half with int8 turns half off."""
    y = YOLO(INT8_CFG, device="cpu", param_dtype=torch.float32)
    path = y.export(imgsz=64, batch=2, int8=True, half=True, project=str(tmp_path))
    assert "half=False" in capsys.readouterr().out and path.endswith("model_64_int8.pt2")
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["int8"] and not md["half"] and md["batch"] == 2
    be = Backend(path, device="cpu")
    assert swin_ops(be) == ["yolov8_cbam_swin.swin_block_int8.default"]
    rng = np.random.default_rng(0)  # the exporter's synthetic calibration frames
    live = quantize_model(copy.deepcopy(y.model).fuse(), [rng.integers(0, 255, (8, 64, 64, 3), np.uint8)
                                                         for _ in range(2)])
    img = frames(2, seed=5)
    np.testing.assert_array_equal(be(img), Backend(live)(img))
    with pytest.raises(ValueError, match="fp32 weights"):  # bf16 weights cannot be quantized
        YOLO(copy.deepcopy(CFG), device="cpu", dtype=torch.bfloat16).export(imgsz=64, int8=True,
                                                                          project=str(tmp_path))


def test_int8_dynamic_program_serves_batches_1_and_3(tmp_path):
    """int8 with dynamic=True: one program serves batches 1 and 3, equal bit
    for bit to the live quantized model at each. Its convs reach int_mm with
    one image's rows at 16 (4x4) and 4 (2x2), where the pad is decided by
    those rows, not by the batch; its SwinBlock is K4's operator."""
    y = YOLO(INT8_CFG, device="cpu", param_dtype=torch.float32)
    path = y.export(imgsz=64, int8=True, dynamic=True, project=str(tmp_path))
    assert yaml.safe_load(open(f"{path}.yaml"))["batch"] == -1
    be = Backend(path, device="cpu")
    assert swin_ops(be) == ["yolov8_cbam_swin.swin_block_int8.default"]
    rng = np.random.default_rng(0)  # the exporter's synthetic calibration frames
    live = Backend(quantize_model(copy.deepcopy(y.model).fuse(), [rng.integers(0, 255, (8, 64, 64, 3), np.uint8)
                                                                  for _ in range(2)]))
    for b in (1, 3):
        img = frames(b, seed=b)
        out = be(img)
        assert out.shape == (b, 5, 84)
        np.testing.assert_array_equal(out, live(img))


def test_calibration_falls_back_to_synthetic_frames(tmp_path, capsys):
    """_calib_batches on a data YAML that cannot be read warns and gives the
    synthetic frames, as the JAX exporter does; so does a dataset without
    images."""
    bad = tmp_path / "bad.yaml"
    bad.write_text("path: /nonexistent\ntrain: images/train\nval: images/val\nnc: 1\nnames: [a]\n")
    rng = np.random.default_rng(0)
    synthetic = [rng.integers(0, 255, (8, 64, 64, 3), dtype=np.uint8) for _ in range(2)]
    for data in (str(bad), str(tmp_path / "missing.yaml")):
        got = Exporter(None, get_cfg({"int8": True, "imgsz": 64, "data": data}))._calib_batches()
        assert len(got) == 2 and all(np.array_equal(a, b) for a, b in zip(got, synthetic))
        assert "using synthetic frames" in capsys.readouterr().out


def test_default_class_names_falls_back_as_jax(tmp_path):
    """A data YAML that cannot be read gives COCO's 80 names, as the JAX
    package's default_class_names does; a readable one gives its own."""
    from improving_yolov8_cbam_swinblock_tpu.nn.autobackend import default_class_names as jax_default_class_names

    for data in (str(tmp_path / "missing.yaml"), str(tmp_path)):
        got = default_class_names(data)
        assert got == jax_default_class_names(data) and len(got) == 80 and got[0] == "person"
    good = make_synth_dataset(tmp_path / "synth", n_train=1, n_val=1, imgsz=32, nc=2)
    assert default_class_names(str(good)) == jax_default_class_names(str(good))


@pytest.mark.parametrize("fmt", ["stablehlo", "saved_model", "tflite", "pb", "onnx"])
def test_formats_the_port_does_not_write_raise(both, fmt):
    with pytest.raises(ValueError, match="pt2"):
        both.y.export(format=fmt)


def test_option_rules(both, capsys):
    y = both.y
    with pytest.raises(ValueError, match="keras"):
        y.export(keras=True)
    opts = Exporter(y.model, get_cfg({"int8": True, "dynamic": True}))._resolve_options()
    assert opts["int8"] and opts["dynamic"]  # one int8 program serves any batch
    args = get_cfg({"half": True, "int8": True, "opset": 12, "simplify": False, "workspace": 4, "optimize": True,
                    "dnn": True})
    opts = Exporter(y.model, args)._resolve_options()
    assert opts == {"batch": 16, "dynamic": False, "half": False, "int8": True, "nms": False}
    out = capsys.readouterr().out
    assert all(f"export arg {k}=" in out for k in ("opset", "simplify", "workspace", "optimize", "dnn"))
    with pytest.raises(NotImplementedError, match="ensemble"):
        Exporter(EnsembleModel([y.model]), get_cfg({}))()
    fired = []
    y2 = YOLO(copy.deepcopy(CFG), device="cpu")
    for event in ("on_export_start", "on_export_end"):
        y2.add_callback(event, lambda ex, e=event: fired.append(e))
    with pytest.raises(ValueError):
        y2.export(format="tflite")
    assert fired == ["on_export_start"]
    assert export_formats()["Argument"] == ["pt2", "torch", "ckpt"]


def test_swin_operators_pass_opcheck():
    rng = np.random.default_rng(0)
    c, heads = 128, 1

    def r(*shape, s=0.05):
        return torch.tensor(rng.normal(0, s, shape).astype(np.float32))

    shapes = {"ln1_w": (c,), "ln1_b": (c,), "wqkv": (3 * c, c), "bqkv": (3 * c,), "wout": (c, c), "bout": (c,),
              "ln2_w": (c,), "ln2_b": (c,), "w1": (4 * c, c), "b1": (4 * c,), "w2": (c, 4 * c), "b2": (c,)}
    p = {k: r(*s) for k, s in shapes.items()}
    x = r(2, 9, 8, c, s=1.0)
    for fast in (True, False):
        torch.library.opcheck(S.swin_block_op, (x, [p[k] for k in S.PKEYS], heads, 7, fast))
    q = {}
    for k in S8.QKEYS:
        w = p[S8.QWEIGHTS[k]]
        scale = w.abs().amax(1) / 127
        q.update({f"{k}_w_int8": torch.round(w / scale[:, None]).to(torch.int8), f"{k}_w_scale": scale,
                  f"{k}_x_scale": torch.tensor(0.05)})
    q.update(x_in_scale=torch.tensor(0.03), y_out_scale=torch.tensor(0.04))
    x8 = torch.clamp(torch.round(x / 0.03), -127, 127).to(torch.int8)
    pv, qv = [p[k] for k in S8._VECTORS], [q[k] for k in S8.QNAMES]
    for xin, in8, out8, sm16 in ((x8, True, True, False), (x, False, False, False), (x8, True, False, True)):
        torch.library.opcheck(S8.swin_block_int8_op, (xin, pv, qv, heads, 7, in8, out8, sm16))


def test_e2e_postprocess_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    pred = rng.uniform(0, 1, (2, 6, 40)).astype(np.float32)
    pred[:, 4:, 10:20] = 0.5  # ties within and across anchors
    for max_det, nc in ((300, 2), (15, 2)):
        np.testing.assert_array_equal(e2e_postprocess(torch.from_numpy(pred), max_det, nc).numpy(),
                                      np.asarray(jax_e2e_postprocess(pred, max_det, nc)))


def test_backend_on_jax_ckpt_matches_jax_backend(both):
    path = str(both.d / "jax.ckpt")
    be, jbe = Backend(path, device="cpu"), JaxBackend(path)
    img = frames(3, seed=3)
    np.testing.assert_allclose(be(img), np.asarray(jbe(img)), rtol=RTOL, atol=ATOL)
    assert (be.format, be.names, be.stride, be.nc) == ("ckpt", jbe.names, jbe.stride, jbe.nc)
    assert be.warmup() is be
    with pytest.raises(ValueError, match="backend"):
        Backend(str(both.d / "model.onnx"), device="cpu")
    assert check_class_names(["a", "b"]) == {0: "a", 1: "b"}
    with pytest.raises(KeyError):
        check_class_names({0: "a", 5: "b"}, nc=2)
    assert len(default_class_names()) == 80 and default_class_names()[0] == "person"


def test_benchmark_rows_agree_on_map(both, tmp_path):
    data = make_synth_dataset(tmp_path / "synth", n_train=4, n_val=4, imgsz=64, nc=1)
    rows = both.y.benchmark(formats=["torch", "pt2"], imgsz=64, batch=2, iters=2, data=str(data))
    assert [(r["format"], r["status"]) for r in rows] == [("torch", "ok"), ("pt2", "ok")]
    assert rows[0]["mAP50-95"] == rows[1]["mAP50-95"] and rows[0]["mAP50"] == rows[1]["mAP50"]
    assert all(r["ms/batch"] > 0 and r["img/s"] > 0 for r in rows)
    rows = both.y.benchmark(formats=["stablehlo"], imgsz=64, batch=2, iters=1)
    assert rows[0]["status"].startswith("error")


def test_seg_program_equals_the_live_model(tmp_path):
    """yolov8n-seg (BN-folded, class priors zeroed so that boxes come)
    exported with a dynamic batch: its two outputs equal the live forward's
    bit for bit at batches 1 and 3; YOLO(path) serves it (task segment) and
    its predict gives the live model's boxes and masks at batches 1 and 3."""
    from tests.seeded_scores import zero_class_priors

    y = YOLO("yolov8n-seg.yaml", device="cpu").fuse()
    zero_class_priors(y.model)
    path = y.export(imgsz=64, dynamic=True, project=str(tmp_path))
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["task"] == "segment" and md["batch"] == -1 and "prototypes" in md["layout"]
    served = YOLO(path, device="cpu")
    assert served.task == "segment" and served.overrides["imgsz"] == 64
    be, live = served.model.backend, Backend(y.model)
    for b in (1, 3):
        img = frames(b, seed=b)
        (pred, proto), (rpred, rproto) = be(img), live(img)
        assert pred.shape == (b, 4 + 80 + 32, 84) and proto.shape == (b, 32, 16, 16)
        np.testing.assert_array_equal(pred, rpred)
        np.testing.assert_array_equal(proto, rproto)
    with pytest.raises(ValueError, match="detect-task"):
        y.export(imgsz=64, nms=True, project=str(tmp_path))
    src = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8) for i in range(3)]
    for b in (1, 3):
        got = served.predict(src, conf=0.25, batch=b, verbose=False)
        ref = y.predict(src, imgsz=64, conf=0.25, batch=b, verbose=False)
        assert sum(len(r) for r in ref) > 0
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.boxes.data, r.boxes.data)
            np.testing.assert_array_equal(g.masks.data, r.masks.data)
    with pytest.raises(NotImplementedError, match="program"):
        served.export(imgsz=64)


# a small YOLOv10 graph for the int8 program: SCDown rows to strides 8, 16 and 32, and the v10Detect head
V10_INT8_CFG = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                                      [-1, 1, "SCDown", [32, 3, 2]], [-1, 1, "SCDown", [64, 3, 2]],
                                      [-1, 1, "SCDown", [64, 3, 2]]],
                "head": [[[2, 3, 4], 1, "v10Detect", ["nc"]]]}


def test_v10_int8_program_keeps_the_head_layout(tmp_path, capsys):
    """A YOLOv10 int8 program (dynamic batch, nms asked for and dropped):
    the sidecar says end2end and int8, the program returns the head's
    (B, 84, 6) xyxy detections (min(300, A) at 64 px), bit for bit with the
    live model quantized on the exporter's synthetic frames, at batches 1
    and 3, and YOLO(path).predict gives the live model's detections."""
    y = YOLO(V10_INT8_CFG, device="cpu", param_dtype=torch.float32)
    path = y.export(imgsz=64, int8=True, dynamic=True, nms=True, project=str(tmp_path))
    assert "nms=True on a YOLOv10" in capsys.readouterr().out and path.endswith("model_64_int8.pt2")
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["end2end"] and md["int8"] and not md["nms"] and md["max_det"] == 300 and "xyxy" in md["layout"]
    rng = np.random.default_rng(0)  # the exporter's synthetic calibration frames
    live = YOLO(V10_INT8_CFG, device="cpu", param_dtype=torch.float32).fuse()
    quantize_model(live.model, [rng.integers(0, 255, (8, 64, 64, 3), np.uint8) for _ in range(2)])
    served = YOLO(path, device="cpu")
    for b in (1, 3):
        img = frames(b, seed=b)
        out = served.model.backend(img)
        assert out.shape == (b, 84, 6)
        np.testing.assert_array_equal(out, Backend(live.model)(img))
    src = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8) for i in range(3)]
    got = served.predict(src, conf=0.001, batch=3, verbose=False)
    ref = live.predict(src, imgsz=64, conf=0.001, batch=3, verbose=False)
    assert sum(len(r) for r in ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.boxes.data, r.boxes.data)


# the tiny RT-DETR graph of its test file (AIFI, a two-layer decoder of 16 queries), and a World graph of each World
# block in eight rows (C2fAttn, ImagePoolingAttn, WorldDetect with worldv2's BN contrastive heads) at two prompts:
# what the program cases test does not depend on the graph's depth, and an int8 program's export time grows with
# its convs
COMPACT_WORLD = {"nc": 3, "backbone": [[-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                                       [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [24, 3, 2]],
                                       [-1, 1, "Conv", [32, 3, 2]]],
                 "head": [[-1, 1, "C2fAttn", [32, 16, 2]], [[2, 3, -1], 1, "ImagePoolingAttn", [16]],
                          [[2, 3, 5], 1, "WorldDetect", ["nc", 512, True]]]}  # embed: the text width
WORLD_NAMES = ["cat", "dog"]


def small_graph(kind):
    from tests.test_torch_rtdetr import TINY_RTDETR

    return copy.deepcopy(TINY_RTDETR if kind == "rtdetr" else COMPACT_WORLD)


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
@pytest.mark.parametrize("kind", ["rtdetr", "world"])
def test_rtdetr_and_world_programs_equal_the_live_model(tmp_path, kind, dynamic, int8):
    """An RT-DETR and a World graph (BN-folded, class priors zeroed), float
    and int8 (quantized on the exporter's synthetic frames), at a static
    batch of 3 and with a dynamic batch: the program's output equals the
    live model's bit for bit at each batch it takes, and YOLO(path).predict
    gives the live model's detections. The RT-DETR sidecar gives the
    NMS-free query layout (B, 16, 4 + nc) and the predictor keeps its
    queries (no NMS); the World program holds the text features of the
    prompts set before export (its sidecar's names), and set_classes on it
    raises, naming the live model. The RT-DETR program holds the encoder's
    stable sort (its top-k, the lower index first) and grid_sample."""
    from tests.seeded_scores import zero_class_priors

    y = YOLO(small_graph(kind), device="cpu", param_dtype=torch.float32)
    if kind == "world":
        y.set_classes(WORLD_NAMES)
    zero_class_priors(y.model)
    y.fuse()
    path = y.export(imgsz=64, int8=int8, dynamic=dynamic, batch=3, project=str(tmp_path))
    md = yaml.safe_load(open(f"{path}.yaml"))
    assert md["int8"] == int8 and md["batch"] == (-1 if dynamic else 3) and md["task"] == "detect"
    live = copy.deepcopy(y)
    if int8:
        rng = np.random.default_rng(0)  # the exporter's synthetic calibration frames
        quantize_model(live.model, [rng.integers(0, 255, (8, 64, 64, 3), np.uint8) for _ in range(2)])
    served = YOLO(path, device="cpu")
    nc = 3 if kind == "rtdetr" else len(WORLD_NAMES)
    if kind == "rtdetr":
        assert md["is_rtdetr"] and md["nq"] == 16 and "(B, nq, 4+nc)" in md["layout"] and served.model.is_rtdetr
        ops = {str(n.target) for n in served.model.backend._fn.graph.nodes}
        assert {"aten.sort.stable", "aten.grid_sampler.default"} <= ops  # the encoder's stable top-k, the sampling
    else:
        assert md["names"] == dict(enumerate(WORLD_NAMES)) and md["nc"] == nc and served.names == md["names"]
        with pytest.raises(ValueError, match="live model"):
            served.set_classes(["bus"])
    for b in (1, 3) if dynamic else (3,):
        img = frames(b, seed=b)
        out = served.model.backend(img)
        assert out.shape == ((b, 16, 4 + nc) if kind == "rtdetr" else (b, 4 + nc, 84))
        np.testing.assert_array_equal(out, Backend(live.model)(img))
    src = [np.random.default_rng(i).integers(0, 256, (48, 80, 3), dtype=np.uint8) for i in range(3)]
    got = served.predict(src, conf=0.25, batch=3, verbose=False)
    ref = live.predict(src, imgsz=64, conf=0.25, batch=3, verbose=False)
    assert sum(len(r) for r in ref) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.boxes.data, r.boxes.data)
