"""The YAML rows that RT-DETR brought to the port's parse_model, and every graph built before them unchanged.

`tests/golden/port_graphs.json` holds, for each of the 46 model YAMLs the
port built before the long Conv form and the DWConv, LightConv and RepC3
rows were added (at each file's default scale), its parameter count, its
number of state tensors and a hash of its state names and shapes, written
by this file's `graph_record` on that tree. Each graph is built again on
the meta device (nothing allocated) and must match its record.

The rows: Conv's long form [c2, k, s, p, g, d, act] with act False (no
activation), g or d other than 1 raising; DWConv [c2, k, s, d, act] with
groups gcd(c1, c2) and its stride in the layer's stride; LightConv and
RepC3 as rows; a YAML-level ReLU on Conv and DWConv rows that name no
activation, as the JAX package applies it.
"""

import hashlib
import json
from pathlib import Path

import pytest
import torch

from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import parse_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

GOLDEN = json.loads((Path(__file__).parent / "golden" / "port_graphs.json").read_text())


def graph_record(cfg: str) -> dict:
    with torch.device("meta"):
        m = DetectionModel(cfg, device="meta")
    sd = m.state_dict()
    digest = hashlib.sha256("\n".join(f"{k}:{tuple(v.shape)}" for k, v in sd.items()).encode()).hexdigest()
    return {"params": sum(t.numel() for t in m.parameters()), "sha256": digest[:16], "tensors": len(sd)}


def test_the_46_graphs_are_unchanged():
    assert len(GOLDEN) == 46
    now = {cfg: graph_record(cfg) for cfg in sorted(GOLDEN)}
    assert {cfg: rec for cfg, rec in now.items() if rec != GOLDEN[cfg]} == {}


def rows(*head_rows, activation=None):
    d = {"nc": 2, "backbone": [[-1, 1, "Conv", [16, 3, 2]]], "head": list(head_rows)}
    if activation:
        d["activation"] = activation
    return d


def test_conv_long_form_and_dwconv_rows():
    layers, _, _ = parse_model(rows([-1, 1, "Conv", [24, 1, 1, None, 1, 1, False]],
                                    [-1, 1, "DWConv", [24, 3, 2, 1, False]], [-1, 1, "DWConv", [48, 3, 1]],
                                    [-1, 1, "Conv", [32, 3, 1, 1]]))
    conv, dw, dw2, conv_p = layers[1:]
    assert conv.act is False and conv.conv.padding == (0, 0) and conv.conv.kernel_size == (1, 1)
    assert isinstance(dw, M.DWConv) and dw.act is False and dw.conv.groups == 24 and dw.conv.stride == (2, 2)
    assert dw2.act is True and dw2.conv.groups == 24 and dw2.conv.out_channels == 48
    assert conv_p.conv.padding == (1, 1) and conv_p.act is True
    m = DetectionModel(rows([-1, 1, "DWConv", [16, 3, 2, 1, False]], [-1, 1, "Conv", [16, 1, 1]],
                            [[-1], 1, "Detect", ["nc"]]), device="cpu")
    assert m.strides == (4,)
    for bad in ([-1, 1, "Conv", [24, 3, 1, None, 2, 1, False]], [-1, 1, "Conv", [24, 3, 1, None, 1, 2]],
                [-1, 1, "DWConv", [24, 3, 1, 2]]):
        with pytest.raises(KeyError, match="groups or dilation|dilation"):
            parse_model(rows(bad))


def test_lightconv_and_repc3_rows_and_the_relu_override():
    layers, _, _ = parse_model(rows([-1, 1, "LightConv", [24, 5]], [-1, 3, "RepC3", [32]]))
    light, rep = layers[1:]
    assert isinstance(light, M.LightConv) and light.conv2.conv.groups == 24 and light.conv2.act == "relu"
    assert isinstance(rep, M.RepC3) and len(rep.m) == 3 and isinstance(rep.cv3, torch.nn.Identity)
    layers, _, _ = parse_model(rows([-1, 1, "Conv", [24, 1, 1, None, 1, 1, False]], [-1, 1, "DWConv", [24, 3, 1]],
                                    [-1, 1, "Conv", [24, 3, 1]], activation="nn.ReLU()"))
    assert [m.act for m in layers] == ["relu", False, "relu", "relu"]
