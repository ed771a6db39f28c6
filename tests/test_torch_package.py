"""The port package and chip_smoke.py stand alone: no JAX, the device rule, the YAML compiler, anchors."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.ops import anchors as JA
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import CFG_DIR, make_divisible, parse_model, yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import anchors as TA
from improving_yolov8_cbam_swinblock_tpu_torch.utils.device import select_device

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "improving_yolov8_cbam_swinblock_tpu_torch"
JAX_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|flax|jaxlib|improving_yolov8_cbam_swinblock_tpu(?!_torch))\b",
                        re.M)


def test_no_module_of_the_port_imports_jax_source_scan():
    """Every module of the package, and chip_smoke.py, which runs on a
    machine that has no JAX."""
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    offenders = [str(f.relative_to(ROOT)) for f in files if JAX_IMPORT.search(f.read_text())]
    assert offenders == []


def test_no_module_of_the_port_imports_jax_at_run_time():
    code = (
        "import pkgutil, importlib, sys\n"
        "import improving_yolov8_cbam_swinblock_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'jaxlib',"
        " 'improving_yolov8_cbam_swinblock_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]), bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 15 and bad.strip() == "[]"


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the entry points run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLO("yolov8n-cbam-swin.yaml")
    with pytest.raises(RuntimeError, match="CUDA"):
        DetectionModel("yolov8n-cbam-swin.yaml", device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionTrainer(overrides={"model": "yolov8n-cbam-swin.yaml"})
    with pytest.raises(RuntimeError):
        select_device("cuda:0")
    assert select_device("cpu") == torch.device("cpu")


def test_int8_path_raises_without_cuda():
    """The int8 path's entry point and its kernel wrapper: no device given
    means the card, and without one they raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the int8 path runs there")
    from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8

    with pytest.raises(RuntimeError, match="device='cpu'"):
        YOLO("yolov8s-cbam-swin.yaml", dtype=torch.bfloat16, param_dtype=torch.float32)
    x = torch.zeros(1, 7, 7, 128, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        swin_int8.swin_block_int8_cuda(x, {}, {}, 1, in8=True, out8=True)


def test_yaml_scale_resolution():
    d = yaml_model_load("yolov8s-cbam-swin.yaml")
    assert d["scale"] == "s" and Path(d["yaml_file"]).name == "yolov8-cbam-swin.yaml"
    assert Path(d["yaml_file"]).is_relative_to(CFG_DIR)
    assert yaml_model_load("yolov8-cbam-swin.yaml").get("scale") is None
    with pytest.raises(FileNotFoundError):
        yaml_model_load("yolov99z-nothing.yaml")
    assert make_divisible(1024 * 0.25) == 256 and make_divisible(13.5, 8) == 16


def test_parse_model_channels_and_unknown_module():
    layers, save, meta = parse_model(yaml_model_load("yolov8s-cbam-swin.yaml"))
    assert len(layers) == 27 and meta["width"] == 0.5
    assert [type(layers[i]).__name__ for i in (7, 10, 11, 12, 16, 26)] == \
        ["SwinBlock", "CBAM", "SPPF", "SPPF", "SwinBlock", "Detect"]
    assert layers[11].k == 5 and layers[12].k == 7
    assert layers[7].norm1.weight.numel() == layers[16].norm1.weight.numel() == 256
    assert save == [4, 7, 10, 16, 19, 22, 25]
    d = yaml_model_load("yolov8n-cbam-swin.yaml")
    d["head"] = d["head"][:-1] + [[-1, 1, "C2fPSA", [256]]]
    with pytest.raises(KeyError, match="C2fPSA"):
        parse_model(d)


def test_anchors_and_dfl_match_jax():
    shapes, strides = [(4, 6), (2, 3), (1, 2)], (8, 16, 32)
    pa, sa = TA.make_anchors(shapes, strides)
    ja, js = JA.make_anchors(shapes, strides)
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(sa.numpy(), np.asarray(js))
    logits = np.random.default_rng(0).normal(0, 2, (2, 32, 64)).astype(np.float32)  # (B, A, 4*16)
    ref = np.asarray(JA.dfl_decode(jnp.asarray(logits), 16))  # (B, A, 4)
    out = TA.dfl_decode(torch.from_numpy(logits).transpose(1, 2).contiguous(), 16).transpose(1, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    dist = np.abs(ref)
    jb = np.asarray(JA.dist2bbox(jnp.asarray(dist), jnp.asarray(np.asarray(ja)[:32])[None], xywh=True))
    tb = TA.dist2bbox(torch.from_numpy(dist).transpose(1, 2), pa[:32].t()[None]).transpose(1, 2)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=1e-6, atol=1e-5)


def test_flagship_yaml_is_a_copy():
    jax_yaml = ROOT / "improving_yolov8_cbam_swinblock_tpu/cfg/models/v8/yolov8-cbam-swin.yaml"
    assert (CFG_DIR / "models/v8/yolov8-cbam-swin.yaml").read_text() == jax_yaml.read_text()
