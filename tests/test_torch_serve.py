"""Serving a model from files, the port against the JAX package: `.ckpt`
checkpoints both ways, predict's sources, Results and their files, and
YOLO(ckpt).predict(dir).

The weights are the JAX package's seeded variables of yolov8n-cbam-swin
(tests/test_torch_model.py's seeded_variables: no JAX init compile). The
one JAX compile of this module is JAX YOLO.predict at 64 px. Checkpoints
are held bit for bit, sources, NMS-free text outputs and drawings exactly,
and detections as tests/test_torch_predict.py holds them (rtol 2e-3, atol
2e-2 px: the same fp32 math summed in another order).
"""

import json
import re
import sqlite3
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser
from PIL import Image

from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
from improving_yolov8_cbam_swinblock_tpu.cfg import DEFAULT_CFG_PATH as JAX_DEFAULT_CFG
from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.engine.predictor import DetectionPredictor as JaxPredictor
from improving_yolov8_cbam_swinblock_tpu.engine.results import Results as JaxResults
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.cfg import DEFAULT_CFG, get_cfg
from improving_yolov8_cbam_swinblock_tpu_torch.data.build import check_source
from improving_yolov8_cbam_swinblock_tpu_torch.engine.predictor import DetectionPredictor
from improving_yolov8_cbam_swinblock_tpu_torch.engine.results import Results
from improving_yolov8_cbam_swinblock_tpu_torch.utils import serialization as S
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax, jax_variables_from_state,
                                                                        state_dict_from_jax)
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
ROOT = Path(__file__).resolve().parent.parent
NAMES = {0: "person", 1: "bus"}


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory):
    """Seeded variables, and the files JAX YOLO.save writes from them, unfused and fused."""
    d = tmp_path_factory.mktemp("ckpt")
    v = seeded_variables(JaxDetectionModel(CFG), 64, np.random.default_rng(0))
    jy = JaxYOLO(CFG)
    jy.variables = v
    jy.save(str(d / "jax.ckpt"))
    jy.fuse()
    jy.save(str(d / "jax_fused.ckpt"))
    fused = jax.tree.map(np.asarray, jy.variables)
    return d, v, fused


def leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def bits(x):
    """A leaf as (dtype name, shape, raw bytes): bfloat16 tensors and arrays alike."""
    if isinstance(x, torch.Tensor):
        return "bfloat16", tuple(x.shape), x.view(torch.int16).numpy().tobytes()
    x = np.asarray(x)
    return x.dtype.name, x.shape, x.tobytes()


def same_tree(a, b) -> bool:
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list) or isinstance(b, list):
        return isinstance(a, list) and isinstance(b, list) and len(a) == len(b) and all(map(same_tree, a, b))
    if isinstance(a, (np.ndarray, np.generic, torch.Tensor)) or hasattr(a, "dtype"):
        return bits(a) == bits(b)
    return type(a) is type(b) and a == b


def test_reader_reads_jax_save_unfused(jax_files):
    """The port's reader on JAX YOLO.save's bytes gives what flax reads, and
    YOLO(path) holds state_dict_from_jax(variables) bit for bit."""
    d, v, _ = jax_files
    data = (d / "jax.ckpt").read_bytes()
    assert same_tree(S.loads(data), flax_ser.msgpack_restore(data))
    y = YOLO(str(d / "jax.ckpt"), device="cpu")
    ref = state_dict_from_jax(v)
    state = y.model.state_dict()
    assert state.keys() == ref.keys() and all(torch.equal(state[k], ref[k]) for k in ref)
    assert not y.is_fused and y.names == {0: "0"} and y.ckpt_path == str(d / "jax.ckpt")


def test_reader_reads_jax_save_fused(jax_files):
    """A BN-folded JAX checkpoint: the fused port model holds the JAX folded
    kernels (HWIO -> OIHW) and the `fused` biases bit for bit, no BatchNorm."""
    d, _, fused = jax_files
    y = YOLO(str(d / "jax_fused.ckpt"), device="cpu")
    assert y.is_fused
    state = y.model.state_dict()
    assert not any(".bn." in k for k in state)
    np.testing.assert_array_equal(state["model.0.conv.weight"].numpy(),
                                  fused["params"]["model_0"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(state["model.0.conv.bias"].numpy(), fused["fused"]["model_0"]["bias"])
    ref = fused_state_from_jax(fused)
    assert state.keys() == ref.keys() and all(torch.equal(state[k], ref[k]) for k in ref)


def test_writer_bytes_equal_jax_save(jax_files, tmp_path):
    """A model read from JAX YOLO.save's file, written again by the port's
    YOLO.save, is the same file, byte for byte."""
    d, _, _ = jax_files
    YOLO(str(d / "jax.ckpt"), device="cpu").save(str(tmp_path / "port.ckpt"))
    assert (tmp_path / "port.ckpt").read_bytes() == (d / "jax.ckpt").read_bytes()


@pytest.mark.parametrize("fused", [False, True])
def test_writer_read_by_flax_and_jax_yolo(jax_files, tmp_path, fused):
    """The port's YOLO.save read back by flax's msgpack_restore and by JAX
    YOLO(path): the same variables bit for bit (fused: the JAX package's
    folded kernels and biases, carried through the port)."""
    d, v, fv = jax_files
    if fused:
        y = YOLO(str(d / "jax_fused.ckpt"), device="cpu")
        want = {"params": {}, "fused": fv["fused"]}
        for path, leaf in leaves(fv["params"]):
            if "bn" not in path:
                node = want["params"]
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = leaf
    else:
        y = YOLO(CFG, device="cpu").load_jax_variables(v)
        want = {"params": v["params"], "batch_stats": v["batch_stats"]}
    path = tmp_path / "port.msgpack"
    y.save(str(path))
    payload = flax_ser.msgpack_restore(path.read_bytes())
    assert same_tree(payload["ema_params"], want["params"])
    assert same_tree(payload["fused"], want.get("fused", {}))
    assert same_tree(payload["ema_stats"], want.get("batch_stats", {}))
    assert payload["nc"] == 1 and payload["names"] == {"0": "0"} and payload["args"] == {}
    jy = JaxYOLO(str(path))
    assert jy.is_fused == fused and jy.model.nc == 1
    got = jax.tree.map(np.asarray, jy.variables)
    assert same_tree(got["params"], want["params"]) and same_tree(got.get("fused", {}), want.get("fused", {}))
    assert jax_variables_from_state(y.model).keys() == ({"params", "batch_stats", "fused"} if fused
                                                        else {"params", "batch_stats"})


def trainer_payload(v):
    """A checkpoint as the JAX trainer's save_checkpoint writes it, with
    bfloat16 leaves (the momentum buffer), numpy scalars, and None and
    lists inside model_yaml."""
    jm = JaxDetectionModel(CFG)
    yaml = dict(jm.yaml, extra={"none": None, "rows": [[1, None, "x"], [2.5, True]]})
    mom = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), v["params"])
    return {"step": np.asarray(40), "params": v["params"], "batch_stats": v["batch_stats"], "mom_buf": mom,
            "var_buf": {}, "ema_params": v["params"], "ema_stats": v["batch_stats"], "ema_updates": np.asarray(40),
            "epoch": np.asarray(1), "best_fitness": np.asarray(0.125, np.float64), "model_yaml": yaml, "nc": 1,
            "names": {"0": "person"}, "args": {"imgsz": 96, "lr0": 0.01, "amp": True, "name": "train",
                                               "scale": np.float32(0.5)}}


def test_trainer_payload_both_ways(jax_files, tmp_path):
    """A trainer-style last.ckpt: the port reads what flax reads (bfloat16
    as torch.bfloat16 with the same bits, numpy scalars as numpy scalars),
    writes the same bytes flax writes, and YOLO(last.ckpt) serves its EMA
    with its names and imgsz."""
    _, v, _ = jax_files
    payload = trainer_payload(v)
    data = flax_ser.msgpack_serialize(payload)
    mine = S.loads(data)
    assert same_tree(mine, flax_ser.msgpack_restore(data))
    leaf = mine["mom_buf"]["model_0"]["conv"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
    assert isinstance(mine["args"]["scale"], np.float32) and mine["step"].shape == ()
    assert mine["model_yaml"]["extra"] == {"none": None, "rows": [[1, None, "x"], [2.5, True]]}
    assert S.dumps(mine) == data
    (tmp_path / "last.ckpt").write_bytes(data)
    y = YOLO(str(tmp_path / "last.ckpt"), device="cpu")
    ref = state_dict_from_jax(v)
    assert all(torch.equal(y.model.state_dict()[k], ref[k]) for k in ref)
    assert y.names == {0: "person"} and y.overrides == {"imgsz": 96}


def test_warm_start_and_load_from_ckpt(jax_files, tmp_path):
    """pretrained=<.ckpt> overlays the EMA onto the trainer's fresh init, as
    the JAX warm start does; YOLO.load overlays a .ckpt, a .pt and an .npz
    of the reference's torch names by name and shape."""
    d, v, _ = jax_files
    ref = state_dict_from_jax(v)
    tr = DetectionTrainer(overrides={"model": CFG, "pretrained": str(d / "jax.ckpt")}, device="cpu").setup()
    tr._warm_start()
    assert tr.transfer_stats == {"matched": 334, "skipped": 0}
    assert torch.equal(tr.model.state_dict()["model.7.attn.in_proj_weight"], ref["model.7.attn.in_proj_weight"])
    y = YOLO(CFG, device="cpu", seed=3).load(str(d / "jax.ckpt"))
    assert y.transfer_stats == {"matched": 334, "skipped": 0}
    assert all(torch.equal(y.model.state_dict()[k], ref[k]) for k in ref if "num_batches" not in k)
    y.save(str(tmp_path / "a.pt"))
    np.savez(tmp_path / "ref.npz", **{k: t.numpy() for k, t in ref.items() if "cv3" not in k},
             **{"model.26.dfl.conv.weight": np.zeros((1, 16, 1, 1), np.float32)})
    other = YOLO("yolov8n-cbam-swin.yaml", device="cpu", seed=5)
    assert other.load(str(tmp_path / "a.pt")).transfer_stats == {"matched": 334, "skipped": 0}
    before = other.reset_weights().model.state_dict()["model.26.cv3.0.0.conv.weight"].clone()
    stats = other.load(str(tmp_path / "ref.npz")).transfer_stats
    assert stats == {"matched": 334 - 36, "skipped": 36}  # the 36 class-branch leaves the file leaves out
    assert torch.equal(other.model.state_dict()["model.26.cv3.0.0.conv.weight"], before)
    with pytest.raises(ValueError, match="before fuse"):
        other.fuse().load(str(tmp_path / "a.pt"))


def test_fused_checkpoint_is_not_overlaid(jax_files, tmp_path):
    """A BN-folded checkpoint (JAX's, the port's .ckpt, a fused .pt) is
    refused where weights are overlaid onto an unfused graph: YOLO.load,
    pretrained=<path>, and YOLO(fused).train(); YOLO(path) serves it."""
    d, _, _ = jax_files
    served = YOLO(str(d / "jax_fused.ckpt"), device="cpu")
    served.save(str(tmp_path / "port_fused.ckpt"))
    served.save(str(tmp_path / "port_fused.pt"))
    for f in (d / "jax_fused.ckpt", tmp_path / "port_fused.ckpt", tmp_path / "port_fused.pt"):
        assert YOLO(str(f), device="cpu").is_fused
        with pytest.raises(ValueError, match="BN-folded"):
            YOLO(CFG, device="cpu").load(str(f))
        with pytest.raises(ValueError, match="BN-folded"):
            DetectionTrainer(overrides={"model": CFG, "pretrained": str(f)}, device="cpu").setup()._warm_start()
    with pytest.raises(ValueError, match="BN-folded"):
        served.train(data="unused.yaml")


def test_reader_refuses_what_it_does_not_read(jax_files):
    """A chunked leaf (flax splits leaves over 2**30 bytes), a native complex
    (ext 2), trailing and truncated bytes raise; so does writing an object."""
    d, _, _ = jax_files
    chunked = {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 4},
                     "chunks": {"0": np.zeros(2, np.float32), "1": np.zeros(2, np.float32)}}}
    with pytest.raises(S.FormatError, match="chunked"):
        S.loads(flax_ser.msgpack_serialize(chunked))
    with pytest.raises(S.FormatError, match="complex"):
        S.loads(flax_ser.msgpack_serialize({"c": 1 + 2j}))
    data = (d / "jax.ckpt").read_bytes()
    with pytest.raises(S.FormatError, match="after the end"):
        S.loads(data + b"\x00")
    with pytest.raises(S.FormatError, match="truncated"):
        S.loads(data[:-10])
    with pytest.raises(TypeError):
        S.dumps({"x": object()})


def test_no_new_module_imports_flax_or_msgpack():
    """The modules that read and write checkpoints, sources, results and programs import none of jax, flax,
    msgpack."""
    pkg = ROOT / "improving_yolov8_cbam_swinblock_tpu_torch"
    bad = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|msgpack|improving_yolov8_cbam_swinblock_tpu(?!_torch))\b",
                     re.M)
    files = [pkg / f for f in ("utils/serialization.py", "utils/jax_import.py", "utils/callbacks.py",
                               "utils/plotting.py", "data/loaders.py", "data/build.py", "engine/model.py",
                               "engine/predictor.py", "engine/results.py", "nn/tasks.py", "engine/exporter.py",
                               "nn/autobackend.py", "utils/benchmarks.py")]
    assert [str(f) for f in files if bad.search(f.read_text())] == []


def test_default_yaml_keys_match_jax():
    """Every setting of the port has the JAX package's name and default
    (plots excepted: the port draws none; and format: the port exports pt2,
    a format the JAX package does not write)."""
    import yaml

    mine = yaml.safe_load(Path(DEFAULT_CFG).read_text())
    theirs = yaml.safe_load(Path(JAX_DEFAULT_CFG).read_text())
    assert mine["format"] == "pt2" and theirs["format"] == "stablehlo"
    assert {k: (v, theirs.get(k, "missing")) for k, v in mine.items()
            if k not in ("plots", "format") and theirs.get(k, "missing") != v} == {}


# ---------------------------------------------------------------------------
# Sources


@pytest.fixture(scope="module")
def source_dir(tmp_path_factory):
    """Three 64x64 PNGs and a 16-frame MJPG video of 64x48 frames."""
    d = tmp_path_factory.mktemp("src")
    rng = np.random.default_rng(7)
    for i in range(3):
        cv2.imwrite(str(d / f"im{i}.png"), rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    vw = cv2.VideoWriter(str(d / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    for i in range(16):
        vw.write(np.full((48, 64, 3), 16 * i, np.uint8))
    vw.release()
    return d


def jax_and_port_predictors(**kw):
    return JaxPredictor(None, jax_get_cfg(overrides=kw)), DetectionPredictor(None, get_cfg(kw))


@pytest.mark.parametrize("kind", ["dir", "glob", "list", "pil", "array", "tensor", "video", "file"])
def test_load_sources_match_jax(source_dir, kind):
    """Frames and paths equal to the JAX predictor's, for each kind of source."""
    rng = np.random.default_rng(1)
    arr = rng.integers(0, 256, (2, 40, 50, 3), dtype=np.uint8)
    source = {"dir": str(source_dir), "glob": str(source_dir / "im*.png"),
              "list": [str(source_dir / "im2.png"), arr[0], str(source_dir / "clip.avi")],
              "pil": Image.fromarray(arr[1]), "array": arr, "tensor": torch.from_numpy(arr),
              "video": str(source_dir / "clip.avi"), "file": source_dir / "im1.png"}[kind]
    jp, tp = jax_and_port_predictors(vid_stride=2)
    ref, out = jp._load_sources(source), tp._load_sources(source)
    assert [p for _, p in out] == [p for _, p in ref] and len(out) >= 1
    for (a, _), (b, _) in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    if kind == "video":
        assert [p.rsplit("#", 1)[1] for _, p in out] == ["0", "2", "4", "6", "8", "10", "12", "14"]


def test_stream_yields_video_frames_lazily(source_dir):
    """stream=True over a video: one Results per vid_stride-th frame, tagged path#i."""
    y = YOLO(CFG, device="cpu")
    gen = y.predict(str(source_dir / "clip.avi"), stream=True, vid_stride=2, imgsz=64, conf=0.001, verbose=False)
    assert not isinstance(gen, list)
    paths = [r.path for r in gen]
    assert paths == [f"{source_dir / 'clip.avi'}#{i}" for i in range(0, 16, 2)]
    assert check_source("rtsp://h/x")[1].stream and check_source(0)[1].stream and check_source("screen")[1].screenshot
    assert check_source(torch.zeros(1))[1].tensor and check_source([1])[1].from_img


# ---------------------------------------------------------------------------
# Results and the files predict writes


def both_results():
    """A JAX and a port Results over the same image and boxes (three
    detections, two classes, one box cut by the image edge)."""
    img = np.random.default_rng(3).integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[10.4, 12.2, 60.9, 80.1, 0.91, 0], [70, 20, 150.5, 119.9, 0.456, 1],
                      [100, 5, 200, 40, 0.3, 0]], np.float32)
    return JaxResults(img, "im.png", NAMES, boxes), Results(img, "im.png", NAMES, boxes)


def test_results_text_and_pixels_match_jax(tmp_path):
    ref, res = both_results()
    assert res.verbose() == ref.verbose() == "2 persons, 1 bus, "
    assert res.summary() == ref.summary() and res.to_json() == ref.to_json() == res.tojson()
    np.testing.assert_array_equal(res.boxes.xyxyn, ref.boxes.xyxyn)
    np.testing.assert_array_equal(res.boxes.xywhn, ref.boxes.xywhn)
    np.testing.assert_array_equal(res.plot(), ref.plot())
    np.testing.assert_array_equal(res.plot(line_width=5), ref.plot(line_width=5))
    for conf in (False, True):
        a, b = tmp_path / f"a{conf}.txt", tmp_path / f"b{conf}.txt"
        res.save_txt(str(a), save_conf=conf)
        ref.save_txt(str(b), save_conf=conf)
        assert a.read_text() == b.read_text() and len(a.read_text().splitlines()) == 3
    crops, crops_ref = res.save_crop(str(tmp_path / "c"), "im"), ref.save_crop(str(tmp_path / "r"), "im")
    assert [Path(p).relative_to(tmp_path / "c") for p in crops] == [Path(p).relative_to(tmp_path / "r") for p in crops_ref]
    for p, q in zip(crops, crops_ref):
        assert Path(p).read_bytes() == Path(q).read_bytes()
    sub = res[1:]
    assert len(sub) == 2 and sub.path == res.path and len(res[0]) == 1 and sub.verbose() == ref[1:].verbose()
    assert res.new().verbose() == "(no detections), " and len(res.new().update(boxes=ref.boxes.data)) == 3
    db = tmp_path / "r.db"
    res.to_sql(db_path=str(db))
    with sqlite3.connect(db) as con:
        rows = con.execute('SELECT class_name, confidence, data FROM "results"').fetchall()
    assert [(n, c, json.loads(d)) for n, c, d in rows] == [(r["name"], r["confidence"], r) for r in ref.summary()]


def test_save_results_layout_matches_jax(tmp_path, source_dir):
    """predict's save, save_txt, save_conf, save_crop and save_frames write
    the files the JAX package writes, with the same bytes; video frames are
    muxed into <stem>.mp4 (mp4v), which cv2 reads back where it can."""
    ref, res = both_results()
    frames = [(r.orig_img, f"{source_dir / 'clip.avi'}#{i}") for i, r in enumerate([res] * 3)]
    ports = [res] + [Results(img, p, NAMES, res.boxes.data) for img, p in frames]
    jaxes = [ref] + [JaxResults(img, p, NAMES, ref.boxes.data) for img, p in frames]
    kw = dict(save=True, save_txt=True, save_conf=True, save_crop=True, save_frames=True)
    YOLO._save_results(ports, get_cfg({**kw, "project": str(tmp_path / "port")}), kw)
    JaxYOLO._save_results(None, jaxes, jax_get_cfg(overrides={**kw, "project": str(tmp_path / "jax")}), kw)
    a, b = tmp_path / "port" / "predict", tmp_path / "jax" / "predict"
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert Path("clip.mp4") in files and Path("im.jpg") in files and Path("labels/clip.txt") in files
    assert Path("clip_frames/clip_2.jpg") in files and Path("crops/person/im_0.jpg") in files
    for f in files:
        if f.suffix != ".mp4":
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    cap = cv2.VideoCapture(str(a / "clip.mp4"))
    if cap.isOpened():
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()


def test_plotting_matches_jax(tmp_path):
    """The port's Colors, Annotator and save_one_box draw and crop as the JAX package's do."""
    from improving_yolov8_cbam_swinblock_tpu.utils import plotting as JP
    from improving_yolov8_cbam_swinblock_tpu_torch.utils import plotting as TP

    assert [TP.colors(i, bgr) for i in range(20) for bgr in (False, True)] == \
        [JP.colors(i, bgr) for i in range(20) for bgr in (False, True)]
    img = np.random.default_rng(4).integers(0, 256, (90, 120, 3), dtype=np.uint8)
    a, b = TP.Annotator(img.copy(), names=NAMES), JP.Annotator(img.copy(), names=NAMES)
    for ann in (a, b):
        ann.box_label([5, 2, 60, 50], "person 0.91", color=TP.colors(0, True))
        ann.box_label([30, 40, 110, 85], "bus 0.46", color=(240, 240, 240))
        ann.text([10, 60], "text", box_style=True)
    np.testing.assert_array_equal(a.result(), b.result())
    assert a.im is a.img and a.save(str(tmp_path / "a.jpg")) == str(tmp_path / "a.jpg")
    for square in (False, True):
        np.testing.assert_array_equal(TP.save_one_box([10, 20, 50, 70], img, str(tmp_path / "c.jpg"), square=square),
                                      JP.save_one_box([10, 20, 50, 70], img, save=False, square=square))
    assert (tmp_path / "c.jpg").exists()


def test_in_memory_loaders_match_jax():
    """LoadPilAndNumpy, LoadTensor and autocast_list yield the JAX loaders' frames and tags."""
    from improving_yolov8_cbam_swinblock_tpu.data import loaders as JL
    from improving_yolov8_cbam_swinblock_tpu_torch.data import loaders as TL

    arr = np.random.default_rng(5).integers(0, 256, (2, 30, 40, 3), dtype=np.uint8)
    chw = arr.transpose(0, 3, 1, 2).astype(np.float32) / 255.0
    for src, port, ref in ((lambda: [Image.fromarray(arr[0]), arr[1]], TL.LoadPilAndNumpy, JL.LoadPilAndNumpy),
                           (lambda: chw, TL.LoadTensor, JL.LoadTensor), (lambda: arr[0], TL.LoadTensor, JL.LoadTensor)):
        got, want = list(port(src())), list(ref(src()))
        assert [t for _, t in got] == [t for _, t in want] and len(port(src())) == len(want)
        for (x, _), (y, _) in zip(got, want):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(list(TL.LoadTensor(torch.from_numpy(chw)))[1][0], list(JL.LoadTensor(chw))[1][0])
    with pytest.raises(TypeError):
        TL.autocast_list([3])


def test_show_warns_headless(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    YOLO._show_results([])
    assert "GUI" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# YOLO(ckpt).predict(dir) against the JAX package


def test_predict_dir_from_ckpt_matches_jax(jax_files, source_dir, tmp_path):
    """The same checkpoint served by both packages from a directory of 64x64
    PNGs at 64 px (the letterbox is the identity on both sides), batch 2,
    conf 0.01, with the callbacks firing; the label files they write hold
    the same number of lines."""
    d, _, _ = jax_files
    kw = dict(imgsz=64, conf=0.01, batch=2, verbose=False, save_txt=True)
    ref = JaxYOLO(str(d / "jax.ckpt")).predict(str(source_dir), project=str(tmp_path / "jax"), **kw)
    y = YOLO(str(d / "jax.ckpt"), device="cpu")
    events = []
    y.add_callback("on_predict_batch_end", lambda p: events.append(len(p.results)))
    res = y(str(source_dir), project=str(tmp_path / "port"), **kw)
    assert events == [2, 1] and y.is_fused and y.info()["fused"]
    assert [r.path for r in res] == [r.path for r in ref] == [str(source_dir / f"im{i}.png") for i in range(3)]
    assert sum(len(r) for r in res) > 0
    for r, rr in zip(res, ref):
        assert len(r) == len(rr)
        order, order_ref = np.argsort(-r.boxes.conf, kind="stable"), np.argsort(-rr.boxes.conf, kind="stable")
        np.testing.assert_allclose(r.boxes.data[order], rr.boxes.data[order_ref], rtol=2e-3, atol=2e-2)
    for i in range(3):
        lines = (tmp_path / "port/predict/labels" / f"im{i}.txt").read_text().splitlines()
        assert len(lines) == len((tmp_path / "jax/predict/labels" / f"im{i}.txt").read_text().splitlines())
    y.clear_callback("on_predict_batch_end")
    y.predict(str(source_dir / "im0.png"), imgsz=64, verbose=False)
    assert events == [2, 1]
    with pytest.raises(KeyError):
        y.predict(str(source_dir), not_a_setting=1)
    with pytest.raises(ValueError, match="unknown callback"):
        y.add_callback("on_nothing", print)


@pytest.mark.parametrize("event", ["on_train_batch_start", "optimizer_step", "on_before_zero_grad",
                                   "on_train_epoch_end", "on_params_update", "teardown"])
def test_add_callback_refuses_events_never_fired(event):
    """Neither the port nor the JAX package fires these six events: a hook on
    one raises rather than being accepted and ignored."""
    y = YOLO(CFG, device="cpu")
    with pytest.raises(NotImplementedError, match=event):
        y.add_callback(event, print)
    y.add_callback("on_predict_end", print)
    assert y.callbacks["on_predict_end"] == [print] and y.callbacks[event] == []
