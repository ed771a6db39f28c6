"""int8 PTQ of a whole graph in both packages, for the graph test files.

`jax_int8` runs the JAX package's path on a BN-folded tree under one
jax.jit, compiled with `xla_allow_excess_precision` off as
tests/test_torch_quant.py compiles it (and, but for that file's flagship,
at optimization level 0): the calibration pass of its
ops/quant.py calibrate (apply with the `calib` collection mutable, on one
uint8 batch cast to the model's dtype and divided by 255),
build_quant_variables, and the int8 eval forward. `port_int8` runs the port's on a
BN-folded copy of a port model loaded with the same weights: calibrate and
build_quant_state. The assertions hold the two as tests/test_torch_quant.py
holds the flagship's: every calibrated |max| within CALIB_RTOL, the scales
within CALIB_RTOL, the int8 weights equal but for a level where the two
folds' fp32 roundings straddle a boundary, and the outputs within OUT_TOL
of the largest magnitude (OUT_MEAN on average): the float layers' sums in
another order may move a value across the next conv's quantization
boundary, a level, which the layers after it carry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from improving_yolov8_cbam_swinblock_tpu.ops import quant as JQ
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import quant_state_from_jax

CALIB_RTOL = 2e-3
OUT_TOL, OUT_MEAN = 5e-2, 5e-3
EXACT = {"xla_allow_excess_precision": False}
# jax_int8's compile also at XLA's backend optimization level 0 (a shorter compile; the same convs summed in
# another order, far inside CALIB_RTOL and OUT_TOL)
EXACT_QUICK = {**EXACT, "xla_backend_optimization_level": 0}


def jax_int8(jm, v, frames: np.ndarray, x: np.ndarray, options=EXACT_QUICK) -> dict:
    """The JAX package's int8 path: {"calib", "quant", "out"} as numpy trees,
    compiled with `options` (EXACT holds the int8 SwinBlock's bf16 roundings
    bit for bit, which tests/test_torch_quant.py's flagship needs)."""

    def run(fv, img, xx):
        _, mut = jm.apply(fv, img.astype(jm.dtype) / 255.0, train=False, mutable=["calib"])
        qv = JQ.build_quant_variables(fv, mut["calib"])
        return {"calib": mut["calib"], "quant": qv["quant"], "out": jm.apply(qv, xx, train=False)}

    args = (fuse_variables(v), jnp.asarray(frames), jnp.asarray(x))
    return jax.tree.map(np.asarray, jax.jit(run).lower(*args).compile(compiler_options=options)(*args))


def port_int8(pm, frames: np.ndarray) -> dict:
    """The port's: a BN-folded copy of pm calibrated on the same batch, its
    calibration and its own quant state (not loaded)."""
    fm = copy.deepcopy(pm).fuse().eval()
    calib = Q.calibrate(fm, [frames])
    return {"model": fm, "calib": calib, "quant": Q.build_quant_state(fm, calib)}


def to_port_calib(jax_calib) -> dict:
    """JAX's `calib` collection -> {module name: {amax key: tensor}}, the port's calibrate() format."""
    out = {}
    for key, t in quant_state_from_jax(jax_calib).items():
        name, leaf = key.rsplit(".", 1)
        out.setdefault(name, {})[leaf] = t
    return out


def assert_calibration_close(port: dict, ref: dict) -> None:
    """The same modules calibrated, each |max| within CALIB_RTOL."""
    want, got = to_port_calib(ref["calib"]), port["calib"]
    assert got.keys() == want.keys()
    for name, amax in want.items():
        assert got[name].keys() == amax.keys(), name
        for k in amax:
            np.testing.assert_allclose(got[name][k].item(), amax[k].item(), rtol=CALIB_RTOL, err_msg=f"{name}.{k}")


def assert_quant_state_close(port: dict, ref: dict) -> None:
    want, got = quant_state_from_jax(ref["quant"]), port["quant"]
    assert got.keys() == want.keys()
    for k, t in want.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        if t.dtype == torch.int8:
            d = (got[k].int() - t.int()).abs()
            assert d.max() <= 1 and d.float().mean() <= 1e-3, k
        else:
            torch.testing.assert_close(got[k], t, rtol=CALIB_RTOL, atol=0, msg=k)


def int8_with_jax_state(port: dict, ref: dict) -> torch.nn.Module:
    """The port's folded model with JAX's quant state carried in."""
    return Q.load_quant_state(copy.deepcopy(port["model"]), quant_state_from_jax(ref["quant"]))


def assert_out_close(got: np.ndarray, ref: np.ndarray) -> None:
    d, top = np.abs(np.asarray(got, np.float64) - ref), np.abs(ref).max()
    assert got.shape == ref.shape
    assert d.max() <= OUT_TOL * top and d.mean() <= OUT_MEAN * top, (d.max() / top, d.mean() / top)


def assert_int8_geometry(pm) -> None:
    """conv_int8 takes one stride and one padding for both axes and no
    dilation: every ungrouped Conv of the graph has them (quantize_model
    refuses one that has not)."""
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv

    for c in (m.conv for m in pm.modules() if isinstance(m, Conv) and m.conv.groups == 1):
        assert c.stride[0] == c.stride[1] and c.padding[0] == c.padding[1] and tuple(c.dilation) == (1, 1), c
