"""int8 post-training quantization of the fork's YOLO11 graph, the port vs the JAX package.

yolo11n-cbam-swin at 64 px, batch 1, fp32, BN-folded, with its two
SwinBlock rows given one head (C=128, head dim 128): there the JAX package
takes its int8 Pallas path, which it gates on a head dim that is a multiple
of 128 and a TPU backend; the test reports a TPU backend to the JAX package
and runs the Pallas kernels in interpret mode, as tests/test_torch_quant.py
does for the flagship. The JAX side is compiled with XLA's
`xla_allow_excess_precision` off (see that file). YOLO11's grouped convs
(C2PSA Attention's depth-wise `pe`, the depth-wise convs of Detect's class
branch) are calibrated and get quant entries in both packages, and keep
their float path; Attention's qkv and proj convs go int8, its products
stay float.
"""

import copy

import numpy as np
import pytest
import torch

import jax

from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import quant_state_from_jax, state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.int8_parity import jax_int8
from tests.test_torch_quant import jax_on_tpu, to_port_calib
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolo11n-cbam-swin.yaml"
# the int8 graph with JAX's quant tree carried in, against JAX's int8 graph, each output within
# GRAPH_MAX of its largest magnitude and GRAPH_MEAN on average: test_int8_graph_matches_jax's two-head
# bounds (a float block's fp32 sums in another order may move a value across the next conv's
# quantization boundary, a level, which the later layers carry). Measured on these weights, where both
# SwinBlocks run int8 and hand the next conv the same levels: 1.9e-7 max, 8.9e-9 mean (raw Detect maps
# and decoded output; only fp32 rounding remains).
GRAPH_MAX, GRAPH_MEAN = 5e-2, 5e-3


def one_head_yaml(load):
    d = load(CFG)
    for row in d["backbone"] + d["head"]:
        if row[2] == "SwinBlock":
            row[3] = [512, 1]
    return d


@pytest.fixture(scope="module")
def yolo11_int8():
    """Both packages on one seeded yolo11n graph with one-head SwinBlocks,
    fp32, 64 px: JAX fuses, calibrates on one batch of two uint8 frames,
    builds its `quant` collection and runs the int8 graph on a third frame,
    under one jax.jit (tests/int8_parity.py jax_int8); the port loads the
    unfused weights, fuses, calibrates on the same batch and builds its own
    quant state."""
    jm = JaxDetectionModel(one_head_yaml(jax_yaml_model_load))
    v = seeded_variables(jm, 64, np.random.default_rng(11))
    rng = np.random.default_rng(21)
    frames = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    x = frames[2:].astype(np.float32) / 255
    with jax_on_tpu():
        ref = jax_int8(jm, v, frames[:2], x)
    pm = DetectionModel(one_head_yaml(yaml_model_load), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pm.fuse()
    port_calib = Q.calibrate(pm, [frames[:2]])
    out, maps = ref["out"]
    return {"calib": ref["calib"], "quant": ref["quant"], "out": out, "maps": list(maps), "x": x, "port": pm,
            "port_calib": port_calib, "port_quant": Q.build_quant_state(pm, port_calib)}


def test_calibration_matches_jax(yolo11_int8):
    """Every Conv's input |max|, grouped convs and Attention's convs
    included, and each SwinBlock's six, fp32 to 2e-3 relative."""
    ref, got = to_port_calib(yolo11_int8["calib"]), yolo11_int8["port_calib"]
    assert got.keys() == ref.keys()
    assert "model.12.m.0.attn.pe" in got and "model.27.cv3.0.0.0" in got
    for name, amax in ref.items():
        assert got[name].keys() == amax.keys(), name
        for k in amax:
            np.testing.assert_allclose(got[name][k].item(), amax[k].item(), rtol=2e-3, err_msg=f"{name}.{k}")


def test_quant_state_keys_equal_jax(yolo11_int8):
    """The port's quant state names JAX's 292 leaves (88 convs x 3, grouped
    ones included, and 2 SwinBlocks x 14), with JAX's shapes and dtypes: a
    grouped kernel's HWIO (3, 3, 1, O) carried to (O, 1, 3, 3)."""
    got, ref = yolo11_int8["port_quant"], quant_state_from_jax(yolo11_int8["quant"])
    assert got.keys() == ref.keys() and len(ref) == 292
    assert sum(k.endswith(".w_int8") for k in ref) == 88
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
    pe = yolo11_int8["port"].get_submodule("model.12.m.0.attn.pe")
    assert ref["model.12.m.0.attn.pe.w_int8"].shape == pe.conv.weight.shape == (pe.conv.groups, 1, 3, 3)


def test_int8_graph_matches_jax(yolo11_int8):
    """The port's int8 graph with JAX's `quant` tree carried in (the grouped
    entries set on the grouped convs) against JAX's int8 graph: raw Detect
    maps and the decoded output within GRAPH_MAX and GRAPH_MEAN of their
    largest magnitude. Both SwinBlocks run int8."""
    pm = Q.load_quant_state(copy.deepcopy(yolo11_int8["port"]), quant_state_from_jax(yolo11_int8["quant"]))
    assert [m.runs_int8 for m in pm.model if isinstance(m, M.SwinBlock)] == [True, True]
    with torch.no_grad():
        out, maps = pm(torch.from_numpy(yolo11_int8["x"]).permute(0, 3, 1, 2))
    pairs = [(f.permute(0, 2, 3, 1).numpy(), rf) for f, rf in zip(maps, yolo11_int8["maps"])]
    ref = yolo11_int8["out"]
    pairs += [(out[:, :4].numpy(), ref[:, :4]), (out[:, 4:].numpy(), ref[:, 4:])]
    for got, r in pairs:
        d, top = np.abs(got - r), np.abs(r).max()
        assert d.max() <= GRAPH_MAX * top and d.mean() <= GRAPH_MEAN * top, (d.max() / top, d.mean() / top)


def test_grouped_convs_take_the_float_path(yolo11_int8, monkeypatch):
    """With the port's own quant state, one forward runs conv_int8 for each
    of the 80 ungrouped convs and for no grouped one; each of the 8 grouped
    convs gives, bit for bit, what it gives without its quant buffers."""
    pm = Q.load_quant_state(copy.deepcopy(yolo11_int8["port"]), yolo11_int8["port_quant"])
    convs = [m for m in pm.modules() if isinstance(m, M.Conv)]
    grouped = [m for m in convs if m.conv.groups > 1]
    assert len(convs) == 88 and len(grouped) == 8
    assert all(m.w_int8 is not None for m in grouped) and not any(m.runs_int8 for m in grouped)
    seen = []
    real = M.conv_int8
    monkeypatch.setattr(M, "conv_int8", lambda x, w8, *a: seen.append(w8.shape) or real(x, w8, *a))
    inputs = {}
    hooks = [m.register_forward_hook(lambda m, i, o: inputs.__setitem__(m, (i[0], o))) for m in grouped]
    with torch.no_grad():
        pm(torch.from_numpy(yolo11_int8["x"]).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    assert len(seen) == 80
    for m in grouped:
        plain = copy.deepcopy(m)
        for name in m.QNAMES:
            setattr(plain, name, None)
        with torch.no_grad():
            assert torch.equal(plain(inputs[m][0]), inputs[m][1])
