"""The port's int8 post-training quantization vs the JAX package's.

The int8 SwinBlock's plain version (what the CPU runs; the kernel,
csrc/swin_block_int8.cu, is held to it on the card in test_torch_cuda.py)
against the Pallas kernels `fused_swin_block_int8` and, for the bf16 softmax
(sm16), `swin_int8_io` of tools/bench_swin_variants.py, in interpret mode;
the int8 Conv, the calibration and the quant build against the JAX package's;
and the quantized flagship graph end to end. The open-vocabulary and
query graphs: the tiny RT-DETR and World graphs of their test files,
calibrated and quantized by both packages (tests/int8_parity.py): the same
modules calibrated (RT-DETR's backbone Convs and the decoder's input_proj;
World's C2fAttn with its attention's ec and proj_conv, the head's Convs;
not the Linears, ImagePoolingAttn's projections or the heads' last 1x1s),
the quant state equal leaf for leaf, and the int8 forward with JAX's state
carried in within int8_parity's OUT_TOL.

The JAX side is compiled with XLA's `xla_allow_excess_precision` off: on
the CPU, XLA otherwise drops the bf16 roundings between fused elementwise
operations (the kernel's `.astype(bf16)` steps), which the TPU kernel's
program states and the port repeats. With it off, the port's plain version
and the Pallas kernel agree bit for bit in bf16 and int8 here.

The graph test runs the flagship YAML at scale n, 64 px, batch 1, fp32,
BN-folded, with its two SwinBlock rows given one head (C=128, head dim 128):
there the JAX package takes its int8 Pallas path, which it gates on a head
dim that is a multiple of 128 and a TPU backend; the test reports a TPU
backend to the JAX package (a test-time patch of `jax.default_backend`) and
runs the Pallas kernels in interpret mode. At two heads (head dim 64) both
packages keep the float SwinBlock.
"""

import contextlib
import copy
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from improving_yolov8_cbam_swinblock_tpu.nn import modules as JM
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
from improving_yolov8_cbam_swinblock_tpu.ops import quant as JQ
from improving_yolov8_cbam_swinblock_tpu.ops.pallas.swin_kernel import fused_swin_block_int8
from improving_yolov8_cbam_swinblock_tpu.ops.pallas.swin_kernel import swin_gemm_absmax as jax_swin_gemm_absmax
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.nn.modules import Conv, SwinBlock
from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import yaml_model_load
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.ops import swin_int8 as S8
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import quant_state_from_jax, state_dict_from_jax
from tests.int8_parity import (EXACT_QUICK, assert_calibration_close, assert_out_close, assert_quant_state_close,
                                int8_with_jax_state, jax_int8, port_int8)
from tests.test_torch_model import seeded_variables
from tests.test_torch_swin import jax_params, torch_params
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
EXACT = {"xla_allow_excess_precision": False}
HEADS = {"qkv": "wqkv", "out": "wout", "fc1": "w1", "fc2": "w2"}


def jax_exact(fn, *args):
    """jit fn, compiled with the bf16 roundings kept (see the module docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


@contextlib.contextmanager
def jax_on_tpu():
    """The JAX package's SwinBlock sees a TPU backend; Pallas runs in interpret mode."""
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        mp.setattr(jax, "default_backend", lambda: "tpu")
        yield


def quant_entries(p, amax, x_in_amax, y_out_amax):
    """The int8 weights and scales of one block, in JAX (in, out) and port (out, in) layout."""
    qj, qt = {}, {}
    for key, wname in HEADS.items():
        w = p[wname]
        ws = np.clip(np.abs(w).max(0), 1e-12, None) / np.float32(127)
        wi = np.clip(np.round(w / ws), -127, 127).astype(np.int8)
        xs = np.float32(amax[key]) / np.float32(127)
        qj.update({f"{key}_w_int8": wi, f"{key}_w_scale": ws, f"{key}_x_scale": xs})
        qt.update({f"{key}_w_int8": np.ascontiguousarray(wi.T), f"{key}_w_scale": ws, f"{key}_x_scale": xs})
    for q in (qj, qt):
        q.update(x_in_scale=np.float32(x_in_amax) / np.float32(127),
                 y_out_scale=np.float32(y_out_amax) / np.float32(127))
    return ({k: jnp.asarray(v) for k, v in qj.items()}, {k: torch.tensor(np.asarray(v)) for k, v in qt.items()})


def block_case(shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    p = jax_params(shape[-1], rng)
    heads = 1 if shape[-1] == 128 else 2
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, -shape[1] % 7), (0, -shape[2] % 7), (0, 0)))
    am = jax_swin_gemm_absmax(xp, {k: jnp.asarray(v) for k, v in p.items()}, num_heads=heads)
    qj, qt = quant_entries(p, {k: float(v) for k, v in am.items()}, np.abs(x).max(), 4.0)
    return x, p, heads, qj, qt


def assert_close_levels(out, ref, level, max_levels):
    """|out - ref| at most max_levels of `level`, and its median 0 (equal in
    all but a few places: a value within an fp32 rounding of a quantization
    boundary may land one level off, and the block's later products carry it)."""
    d = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert d.max() <= max_levels * level, (d.max(), level)
    assert np.median(d) <= 1e-6 * np.abs(ref).max()


# --------------------------------------------------------------------------------------------
# the int8 SwinBlock (K4) and its bf16 softmax option (K4v)
# --------------------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,io8,shape", [
    ("float32", False, (1, 14, 14, 128)),
    ("bfloat16", False, (1, 14, 14, 128)),
    ("float32", True, (1, 14, 14, 128)),
    ("float32", True, (1, 7, 7, 256)),  # two heads of 128
    ("bfloat16", False, (1, 10, 12, 128)),  # padded: JAX pads, runs the kernel, crops
])
def test_int8_block_plain_matches_pallas_kernel(dtype, io8, shape):
    """Tolerance: bf16 output 2 bf16 ulps of the largest magnitude, int8
    output 1 level, fp32 output 4 levels of the fc2 product's resolution
    (fp32 sums in another order may move a value across a quantization
    boundary); medians 0."""
    x, p, heads, qj, qt = block_case(shape, seed=sum(shape) + io8)
    b, h, w, c = shape
    ph, pw = -h % 7, -w % 7
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if io8:
        xq = np.clip(np.round(x / np.asarray(qj["x_in_scale"])), -127, 127).astype(np.int8)
        xj, xt = jnp.asarray(xq), torch.from_numpy(xq)
    else:
        xj = jnp.asarray(x).astype(dtype)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))

    def run(xx, pp, qq):
        xx = jnp.pad(xx, ((0, 0), (0, ph), (0, pw), (0, 0)))
        return fused_swin_block_int8(xx, pp, qq, num_heads=heads, in8=io8, out8=io8)[:, :h, :w]

    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_exact(run, xj, jp, qj).astype(jnp.float32))
    out = S8.swin_block_int8(xt, torch_params(p), qt, heads, in8=io8, out8=io8)
    assert out.dtype == (torch.int8 if io8 else xt.dtype) and out.shape == xt.shape
    out = out.float().numpy()
    if io8:
        assert_close_levels(out, ref, 1.0, 3)
    elif dtype == "bfloat16":
        assert_close_levels(out, ref, 2.0**-8 * np.abs(ref).max(), 4)
    else:
        fc2_level = float(qj["fc2_x_scale"]) * float(np.asarray(qj["fc2_w_scale"]).max()) * 127
        assert_close_levels(out, ref, fc2_level, 4)


@pytest.fixture(scope="module")
def bench_variants():
    """tools/bench_swin_variants.py, imported with JAX's persistent-cache settings put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    prev = {k: getattr(jax.config, k) for k in keys}
    try:
        return importlib.import_module("tools.bench_swin_variants")
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)


@pytest.mark.parametrize("io8", [False, True])
def test_sm16_plain_matches_variant_kernel(bench_variants, io8):
    """K4v: the bf16 softmax against swin_int8_io(..., sm16=True); compute
    and non-int8 output in bf16. Tolerance as above."""
    x, p, heads, qj, qt = block_case((1, 14, 14, 128), seed=7 + io8)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    if io8:
        xq = np.clip(np.round(x / np.asarray(qj["x_in_scale"])), -127, 127).astype(np.int8)
        xj, xt = jnp.asarray(xq), torch.from_numpy(xq)
    else:
        xj = jnp.asarray(x).astype(jnp.bfloat16)
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_exact(lambda a, b, c: bench_variants.swin_int8_io(
            a, b, c, num_heads=heads, in8=io8, out8=io8, sm16=True), xj, jp, qj).astype(jnp.float32))
    out = S8.swin_block_int8(xt, torch_params(p), qt, heads, in8=io8, out8=io8, sm16=True)
    assert out.dtype == (torch.int8 if io8 else torch.bfloat16)
    out = out.float().numpy()
    if io8:
        assert_close_levels(out, ref, 1.0, 3)
    else:
        assert_close_levels(out, ref, 2.0**-8 * np.abs(ref).max(), 4)
    plain = S8.swin_block_int8(xt, torch_params(p), qt, heads, in8=io8, out8=io8).float().numpy()
    assert not np.array_equal(plain, out)  # sm16 is its own arithmetic


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemm_absmax_matches_jax(dtype):
    """The four product inputs' |max| over padded windows (pad tokens
    included): fp32 to 1e-5, bf16 to one bf16 ulp (2^-8)."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (1, 9, 12, 128)).astype(np.float32)
    p = jax_params(128, rng)
    xj = jnp.pad(jnp.asarray(x).astype(dtype), ((0, 0), (0, 5), (0, 2), (0, 0)))
    ref = jax_swin_gemm_absmax(xj, {k: jnp.asarray(v) for k, v in p.items()}, num_heads=2)
    xt = torch.from_numpy(np.array(jnp.asarray(x).astype(dtype).astype(jnp.float32))).to(getattr(torch, dtype))
    out = S8.swin_gemm_absmax(xt, torch_params(p), 2)
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    for k in S8.QKEYS:
        np.testing.assert_allclose(out[k].item(), float(ref[k]), rtol=tol, err_msg=k)


def test_int8_block_dispatch_on_cpu_never_launches():
    x, p, heads, _, qt = block_case((1, 7, 7, 128), seed=3)
    xt, tp = torch.from_numpy(x), torch_params(p)
    before = S8.swin_block_int8_cuda.launches
    assert torch.equal(S8.swin_block_int8(xt, tp, qt, heads), S8.swin_block_int8_plain(xt, tp, qt, heads))
    assert S8.swin_block_int8_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        S8.swin_block_int8_cuda(xt, tp, qt, heads)
    for impl in ("cuda", "triton"):
        with pytest.raises(ValueError, match="impl"):
            S8.swin_block_int8(xt, tp, qt, heads, impl=impl)
    with pytest.raises(ValueError, match="in8"):
        S8.swin_block_int8(xt, tp, qt, heads, in8=True)


@pytest.mark.parametrize("c,heads,ws,dtype,in8", [
    (96, 2, 7, torch.float32, False),  # C not a multiple of 64
    (256, 2, 8, torch.float32, False),  # window other than 7
    (128, 1, 7, torch.float16, False),  # dtype the kernel lacks
    (128, 1, 7, torch.float32, True),  # in8 without int8 input
    (128, 1, 7, torch.int8, False),  # int8 input without in8
    (768, 2, 7, torch.float32, False),  # fp32 compute at yolo11x's width: no wide layout in fp32
    (192, 8, 7, torch.int8, True),  # head dim 24, not a multiple of the tensor-core tiles' 16
    (384, 4, 7, torch.float32, False),  # fp32 compute: its int8 MLP hidden (64 x 4C) beyond the limit
    (256, 1, 7, torch.float32, False),  # fp32 q|k|v of a 256-wide head beyond the limit
])
def test_int8_kernel_rejects_unsupported(c, heads, ws, dtype, in8):
    with pytest.raises(ValueError):
        S8.check_int8_supported(c, heads, ws, dtype, in8)


@pytest.mark.parametrize("c,heads", [(256, 2), (128, 1), (128, 2)])
def test_int8_kernel_supports_flagship_widths(c, heads):
    for dtype, in8 in ((torch.int8, True), (torch.bfloat16, False), (torch.float32, False)):
        S8.check_int8_supported(c, heads, 7, dtype, in8)


@pytest.mark.parametrize("c", [256, 512, 768])
def test_int8_kernel_takes_the_int8_path_widths(c):
    """The int8 path runs K4 where the head dim is a multiple of 128: the
    2-head blocks at C 256 (flagship s, yolo11s), 512 (flagship l, yolo11m
    and l) and 768 (yolo11x). K4 takes each with int8 I/O within a block's
    shared memory: C=512 in its wide layout, C=768 in the wide layout with
    the fp32 residual stream in the global scratch (230,400 B)."""
    S8.check_int8_supported(c, 2, 7, torch.int8, True)
    S8.check_int8_supported(c, 2, 7, torch.bfloat16, False)
    assert S8.smem_bytes(c, 2, True) <= S8.MAX_SMEM
    assert S8.int8_is_wide(c, 2, True) == (c >= 512)
    assert S8.int8_stream_in_global(c, 2, True) == (c == 768)
    if c == 768:
        assert S8.smem_bytes(c, 2, True) == 230400


# --------------------------------------------------------------------------------------------
# the int8 Conv
# --------------------------------------------------------------------------------------------


@pytest.mark.parametrize("c1,c2,k,s,fused", [(3, 16, 3, 2, True), (16, 32, 1, 1, True), (24, 16, 3, 1, False)])
def test_conv_int8_matches_jax(c1, c2, k, s, fused):
    """The port's quantized Conv against the JAX package's Conv with the
    same `quant` entries, fused bias or BatchNorm: the integer sums are exact
    on both sides, so the outputs agree to fp32 rounding (1e-6 relative)."""
    rng = np.random.default_rng(c1 + k)
    x = rng.normal(0, 1, (2, 11, 13, c1)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, c1, c2)).astype(np.float32)  # HWIO
    ws = np.clip(np.abs(w).max((0, 1, 2)), 1e-12, None) / np.float32(127)
    quant = {"w_int8": np.clip(np.round(w / ws), -127, 127).astype(np.int8), "w_scale": ws,
             "x_scale": np.float32(np.abs(x).max()) / np.float32(127)}
    variables = {"params": {"conv": {"kernel": w}}, "quant": quant}
    bias, gamma, beta = (rng.normal(0, 0.2, c2).astype(np.float32) for _ in range(3))
    mean, var = rng.normal(0, 0.2, c2).astype(np.float32), rng.uniform(0.5, 1.5, c2).astype(np.float32)
    if fused:
        variables["fused"] = {"bias": bias}
    else:
        variables["params"]["bn"] = {"scale": gamma, "bias": beta}
        variables["batch_stats"] = {"bn": {"mean": mean, "var": var}}
    ref = np.asarray(JM.Conv(c2, k, s).apply(variables, jnp.asarray(x), train=False))

    m = Conv(c1, c2, k, s).eval()
    with torch.no_grad():
        m.conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        if fused:
            m.fuse()
            m.conv.bias.copy_(torch.from_numpy(bias))
        else:
            m.bn.weight.copy_(torch.from_numpy(gamma)), m.bn.bias.copy_(torch.from_numpy(beta))
            m.bn.running_mean.copy_(torch.from_numpy(mean)), m.bn.running_var.copy_(torch.from_numpy(var))
    Q.load_quant_state(torch.nn.ModuleDict({"m": m}), quant_state_from_jax({"m": quant}))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        out = m(xt).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("k,s", [(3, 2), (3, 1), (1, 1)])
def test_conv_int8_sums_are_exact(k, s):
    """conv_int8's int32 sums against a float64 convolution of the same
    integer levels (exact in float64)."""
    rng = np.random.default_rng(k * 10 + s)
    x = torch.from_numpy(rng.normal(0, 1, (2, 19, 9, 13)).astype(np.float32))
    w8 = torch.from_numpy(rng.integers(-127, 128, (24, 19, k, k)).astype(np.int8))
    one = torch.ones(24)
    xs = torch.tensor(float(x.abs().max()) / 127)
    out = Q.conv_int8(x, w8, one, xs, s, k // 2) / xs  # the sums, times 1 per channel
    ref = F.conv2d(S8.q8(x, xs).double(), w8.double(), stride=s, padding=k // 2)
    assert torch.equal(torch.round(out.double()), ref)
    assert out.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("m,k,n,min_rows", [(20, 19, 4, 0), (9, 24, 12, 9), (40, 8, 8, 4)])
def test_int_mm_pads_depth_columns_and_rows(m, k, n, min_rows):
    """int_mm's pads (K and N to multiples of 8, 16 rows where the row bound
    is 16 or fewer), which the card's torch._int_mm needs, leave the int32
    product exact: the (M, N) of a float64 product of the same levels."""
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    out = Q.int_mm(a, w, min_rows=min_rows)
    assert out.dtype == torch.int32 and out.shape == (m, n)
    assert torch.equal(out.double(), a.double() @ w.double().t())


# --------------------------------------------------------------------------------------------
# calibration, the quant build and the int8 graph end to end
# --------------------------------------------------------------------------------------------


def graph_yaml(load, heads):
    d = load("yolov8n-cbam-swin.yaml")
    for row in d["backbone"] + d["head"]:
        if row[2] == "SwinBlock":
            row[3] = [256, heads]
    return d


def to_port_calib(jax_calib):
    """JAX's `calib` collection -> {module name: {amax key: tensor}}, the port's calibrate() format."""
    out = {}
    for key, t in quant_state_from_jax(jax_calib).items():
        name, leaf = key.rsplit(".", 1)
        out.setdefault(name, {})[leaf] = t
    return out


@pytest.fixture(scope="module", params=[1, 2], ids=["one_head", "two_heads"])
def graph(request):
    """Both packages on one seeded scale-n graph (SwinBlock heads = param),
    fp32, 64 px: JAX fuses, calibrates on one batch of two uint8 frames,
    builds its `quant` collection and runs the int8 graph on a third frame,
    under one jax.jit (tests/int8_parity.py jax_int8); the port loads the
    unfused weights, fuses, calibrates on the same batch and builds its own
    quant state."""
    heads = request.param
    jm = JaxDetectionModel(graph_yaml(jax_yaml_model_load, heads))
    v = seeded_variables(jm, 64, np.random.default_rng(heads))
    rng = np.random.default_rng(10 + heads)
    frames = rng.integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    x = frames[2:].astype(np.float32) / 255
    with jax_on_tpu():  # one head: EXACT, the int8 SwinBlock's roundings bit for bit; two: at level 0 too
        ref = jax_int8(jm, v, frames[:2], x, EXACT if heads == 1 else EXACT_QUICK)
    pm = DetectionModel(graph_yaml(yaml_model_load, heads), device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    pm.fuse()
    port_calib = Q.calibrate(pm, [frames[:2]])
    out, maps = ref["out"]
    return {"calib": ref["calib"], "quant": ref["quant"], "out": out, "maps": list(maps), "x": x, "port": pm,
            "port_calib": port_calib, "port_quant": Q.build_quant_state(pm, port_calib), "heads": heads}


def test_calibration_matches_jax(graph):
    """Every Conv's input |max| and each SwinBlock's six, fp32 to 2e-3
    relative (the same fp32 graph summed in another order, as
    test_torch_model.py holds the float outputs)."""
    ref, got = to_port_calib(graph["calib"]), graph["port_calib"]
    assert got.keys() == ref.keys()
    for name, amax in ref.items():
        assert got[name].keys() == amax.keys(), name
        for k in amax:
            np.testing.assert_allclose(got[name][k].item(), amax[k].item(), rtol=2e-3, err_msg=f"{name}.{k}")


def test_port_quantization_close_to_jax(graph):
    """The port's own quant state from its BN-folded weights and its
    calibration: scales within 2e-3 (the calibration's tolerance); int8
    weights equal but for a level where the two folds' fp32 roundings
    straddle a boundary."""
    got = graph["port_quant"]
    ref = quant_state_from_jax(graph["quant"])
    assert got.keys() == ref.keys()
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        if t.dtype == torch.int8:
            d = (got[k].int() - t.int()).abs()
            assert d.max() <= 1 and d.float().mean() <= 1e-3, k
        else:
            torch.testing.assert_close(got[k], t, rtol=2e-3, atol=0, msg=k)


def test_int8_graph_matches_jax(graph):
    """The port's int8 graph with JAX's `quant` collection carried in
    against the JAX package's int8 graph: raw Detect maps and the decoded
    output, each within `tol` of its largest magnitude (max) and `mean` on
    average. The integer sums are exact on both sides. One head: the int8
    SwinBlocks agree bit for bit and hand the next conv int8 levels, so
    only fp32 rounding remains (1e-4; measured 1.3e-7). Two heads: both keep
    the float SwinBlock, whose fp32 sums in another order (2e-3 in
    test_torch_model.py) may move values across the next convs'
    quantization boundaries, a level each, which the later layers carry:
    5e-2, mean 5e-3 (measured 1.3e-7 on these weights; 1.5e-2 and 1.5e-3 on
    weights of thrice the variance, where such moves happened)."""
    pm = Q.load_quant_state(copy.deepcopy(graph["port"]), quant_state_from_jax(graph["quant"]))
    swins = [m for m in pm.model if isinstance(m, SwinBlock)]
    assert [m.runs_int8 for m in swins] == [graph["heads"] == 1] * 2
    tol, mean = (1e-4, 1e-5) if graph["heads"] == 1 else (5e-2, 5e-3)
    with torch.no_grad():
        out, maps = pm(torch.from_numpy(graph["x"]).permute(0, 3, 1, 2))
    pairs = [(f.permute(0, 2, 3, 1).numpy(), rf) for f, rf in zip(maps, graph["maps"])]
    pairs += [(out[:, :4].numpy(), graph["out"][:, :4]), (out[:, 4:].numpy(), graph["out"][:, 4:])]
    for got, ref in pairs:
        d, top = np.abs(got - ref), np.abs(ref).max()
        assert d.max() <= tol * top and d.mean() <= mean * top, (d.max() / top, d.mean() / top)


def test_quant_build_matches_jax_on_the_same_weights():
    """build_quant_state against build_quant_variables on the same fp32
    weights of a Conv and a SwinBlock and the same amaxes: int8 weights
    equal, scales equal to fp32 rounding."""
    rng = np.random.default_rng(5)
    kernel = rng.normal(0, 0.2, (3, 3, 8, 16)).astype(np.float32)
    sp = jax_params(128, rng)
    params = {"model_0": {"conv": {"kernel": kernel}},
              "model_1": {"attn": {"in_proj": {"kernel": sp["wqkv"]}, "out_proj": {"kernel": sp["wout"]}},
                          "mlp_fc1": {"kernel": sp["w1"]}, "mlp_fc2": {"kernel": sp["w2"]}}}
    calib = {"model_0": {"x_amax": np.float32(2.5)},
             "model_1": {f"{k}_amax": np.float32(rng.uniform(1, 4))
                         for k in ("qkv", "out", "fc1", "fc2", "xin", "yout")}}
    quant = jax.jit(JQ.build_quant_variables)({"params": params}, calib)["quant"]
    ref = quant_state_from_jax(jax.tree.map(np.asarray, quant))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = torch.nn.ModuleList([Conv(8, 16, 3), SwinBlock(128, 1)])

    net = Net()
    tp = torch_params(sp)
    with torch.no_grad():
        net.model[0].conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        for name, t in net.model[1].kernel_params().items():
            t.copy_(tp[name])
    got = Q.build_quant_state(net, to_port_calib(calib))
    assert got.keys() == ref.keys()
    for k, t in ref.items():
        assert got[k].dtype == t.dtype and got[k].shape == t.shape, k
        if t.dtype == torch.int8:
            assert torch.equal(got[k], t), k
        else:
            torch.testing.assert_close(got[k], t, rtol=1e-6, atol=0, msg=k)


def test_quantized_model_predicts_and_refuses_what_would_break_it(tmp_path):
    """YOLO.predict serves the int8 model with the int8 SwinBlock; save
    refuses it, fuse() after quantizing refuses, bf16 weights are refused,
    and so is a buffer name that no module has."""
    d = graph_yaml(yaml_model_load, 1)
    frame = np.random.default_rng(0).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8)
    y = YOLO(d, device="cpu").fuse()
    quantize_model(y.model, [frame])
    assert all(m.runs_int8 for m in y.model.model if isinstance(m, SwinBlock))
    res = y.predict(frame[0], imgsz=64, conf=0.001)
    assert len(res) == 1 and np.isfinite(res[0].boxes.data).all()
    with pytest.raises(ValueError, match="quantized"):
        y.save(tmp_path / "q.pt")
    with pytest.raises(KeyError):
        Q.load_quant_state(y.model, {"model.7.w_int8": torch.zeros(1, dtype=torch.int8)})
    unfused = YOLO(d, device="cpu")
    Q.load_quant_state(unfused.model, Q.build_quant_state(y.model, {"model.0": {"x_amax": torch.tensor(1.0)}}))
    with pytest.raises(ValueError, match="fuse"):
        unfused.fuse()
    assert len(unfused.predict(frame[0], imgsz=64, conf=0.001)) == 1 and not unfused.is_fused
    with pytest.raises(ValueError, match="fp32"):
        Q.build_quant_state(YOLO(d, device="cpu", dtype=torch.bfloat16).model,
                            {"model.0": {"x_amax": torch.tensor(1.0)}})


# --------------------------------------------------------------------------------------------
# the RT-DETR and World graphs
# --------------------------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["rtdetr", "world"])
def open_graph(request):
    """The tiny RT-DETR or World graph (the World one at three prompts) on
    seeded variables: JAX's int8 path under one jax.jit and the port's on a
    BN-folded copy, calibrated on the same batch of two frames."""
    from tests.test_torch_rtdetr import TINY_RTDETR
    from tests.test_world import TINY_WORLD

    cfg = copy.deepcopy(TINY_RTDETR if request.param == "rtdetr" else TINY_WORLD)
    jm = JaxDetectionModel(copy.deepcopy(cfg))
    pm = DetectionModel(cfg, device="cpu")
    if request.param == "world":
        jm.set_classes(["cat", "dog", "bus"])
        pm.set_classes(["cat", "dog", "bus"])
    v = seeded_variables(jm, 64, np.random.default_rng(30))
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    frames = np.random.default_rng(31).integers(0, 256, (3, 64, 64, 3), dtype=np.uint8)
    x = frames[2:].astype(np.float32) / 255
    return request.param, port_int8(pm, frames[:2]), jax_int8(jm, v, frames[:2], x), x


def test_open_graph_quant_state_matches_jax(open_graph):
    """The same modules calibrated, each |max| and scale within int8_parity's
    CALIB_RTOL, the int8 weights equal but for a level; the Linears and
    ImagePoolingAttn's projections stay float and uncalibrated."""
    kind, port, ref, _ = open_graph
    assert_calibration_close(port, ref)
    assert_quant_state_close(port, ref)
    names = set(port["calib"])
    if kind == "rtdetr":
        assert {"model.0", "model.6.input_proj.0", "model.6.input_proj.2"} <= names
        assert not any(".decoder." in n or n.startswith("model.5") for n in names)
    else:
        assert {"model.5.cv1", "model.5.attn.proj_conv", "model.8.attn.ec", "model.9.cv3.0.1"} <= names
        assert not any(".projections." in n or ".gl" in n or "cv4" in n for n in names)
    convs = [m for m in port["model"].modules() if isinstance(m, Conv)]
    assert len(names) == len(convs)


def test_open_graph_int8_matches_jax(open_graph):
    """The port's int8 graph with JAX's quant state carried in against JAX's
    int8 graph: the RT-DETR queries (boxes and scores) and the World
    prediction (boxes and the prompts' scores), each within int8_parity's
    OUT_TOL of its largest magnitude."""
    kind, port, ref, x = open_graph
    m = int8_with_jax_state(port, ref)
    assert sum(c.runs_int8 for c in m.modules() if isinstance(c, Conv)) > 0
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))[0]
    rout = ref["out"][0]
    if kind == "rtdetr":
        assert out.shape == rout.shape == (1, 16, 7)
        assert_out_close(out[..., :4].numpy(), rout[..., :4])
        assert_out_close(out[..., 4:].numpy(), rout[..., 4:])
    else:
        assert out.shape == rout.shape == (1, 7, 84)
        assert_out_close(out[:, :4].numpy(), rout[:, :4])
        assert_out_close(out[:, 4:].numpy(), rout[:, 4:])
