"""The other detect families in the port vs the JAX package, on the same weights.

Module level (fp32, tolerance 1e-5: the same math, summed in another
order), each in eval mode and in train mode, where the BatchNorms normalise
by the batch and move their running statistics (flax's apply(...,
mutable=["batch_stats"])): SPP, the MaxPool2d and ZeroPad2d rows,
ConvTranspose2d, C2, GhostConv, GhostBottleneck, C3Ghost, RepConv,
RepNCSPELAN4, ELAN1, ADown and AConv on an odd and an even map, SPPELAN,
CBLinear + CBFuse at non-square sizes, and A2C2f with area attention (area
1 and 4, and with the gamma residual) and without (C3k). Graph level:
yolov9t, yolo12n, yolov6n, yolov3-tiny and yolov8n-ghost-p6 at 64 px,
unfused and BN-folded, within 2e-3 as the flagship's test holds them.
Every graph of the slice has JAX's parameter count, loads JAX's variables
strictly and writes them back the same. The loss on four anchor levels, a
JAX BN-folded yolov9t tree and its checkpoints. int8 (tests/int8_parity.py):
yolov9t calibrated and quantized by both packages on the same batch (its
RepConv branches float in both), the calibration, the quant state and the
int8 graph held to JAX's; for yolov6n, yolov8n-ghost-p6 and yolo12n the
set of calibrated convs equal to JAX's (from an abstract trace of its
calibration pass: no compile) and a finite int8 forward; every graph of the
slice's ungrouped convs take conv_int8's square geometry (the bridge test),
and quantize_model refuses one that does not. YOLOv10 has tests/test_torch_v10.py. The JAX modules run
under one jax.jit together and each graph under its own, eval and train mode in the same one.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn import modules_extra as JE
from improving_yolov8_cbam_swinblock_tpu.nn.modules import SPP as JaxSPP
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.fuse import fuse_variables
from improving_yolov8_cbam_swinblock_tpu.utils.loss import detection_loss as jax_detection_loss
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, quantize_model
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules as M
from improving_yolov8_cbam_swinblock_tpu_torch.ops import quant as Q
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import (fused_state_from_jax,
                                                                         jax_variables_from_state,
                                                                         state_dict_from_jax)
from improving_yolov8_cbam_swinblock_tpu_torch.utils.loss import detection_loss
from tests.int8_parity import (assert_calibration_close, assert_int8_geometry, assert_out_close,
                               assert_quant_state_close, int8_with_jax_state, jax_int8, port_int8, to_port_calib)
from tests.test_torch_model import seeded_variables
from tests.test_torch_yolo11 import close, nhwc, seeded_module, to_torch
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-5
GRAPH_TOL = 2e-3

# name: (JAX module, port module, NHWC input shape)
MODULES = {
    "spp": lambda: (JaxSPP(16), M.SPP(24, 16), (2, 9, 8, 24)),
    "conv_transpose": lambda: (JE.ConvTranspose(12, 2, 2, bn=False, act=False), M.ConvTranspose2d(8, 12, 2, 2),
                               (2, 5, 3, 8)),
    "c2": lambda: (JE.C2(32, n=2), M.C2(24, 32, 2), (2, 9, 8, 24)),
    "ghost_conv": lambda: (JE.GhostConv(32, 3, 2), M.GhostConv(24, 32, 3, 2), (2, 9, 8, 24)),
    "ghost_bottleneck_s2": lambda: (JE.GhostBottleneck(32, 3, 2), M.GhostBottleneck(24, 32, 3, 2), (2, 9, 8, 24)),
    "c3ghost": lambda: (JE.C3Ghost(32, n=2), M.C3Ghost(24, 32, 2), (2, 9, 8, 24)),
    "rep_conv": lambda: (JE.RepConv(16), M.RepConv(24, 16), (2, 9, 8, 24)),
    "rep_ncsp_elan4": lambda: (JE.RepNCSPELAN4(32, 32, 16, n=2), M.RepNCSPELAN4(24, 32, 32, 16, 2), (2, 9, 8, 24)),
    "elan1": lambda: (JE.ELAN1(32, 32, 16), M.ELAN1(24, 32, 32, 16), (2, 9, 8, 24)),
    "adown_odd": lambda: (JE.ADown(32), M.ADown(24, 32), (2, 9, 7, 24)),
    "adown_even": lambda: (JE.ADown(32), M.ADown(24, 32), (2, 8, 8, 24)),
    "aconv_odd": lambda: (JE.AConv(32), M.AConv(24, 32), (2, 9, 7, 24)),
    "aconv_even": lambda: (JE.AConv(32), M.AConv(24, 32), (2, 8, 8, 24)),
    "sppelan": lambda: (JE.SPPELAN(32, 16), M.SPPELAN(24, 32, 16), (2, 9, 8, 24)),
    # c_ 64: two heads of 32; 48 tokens, in 4 areas of 12 with area=4
    "a2c2f_area1": lambda: (JE.A2C2f(128, n=1, a2=True, area=1), M.A2C2f(64, 128, 1, True, 1), (2, 8, 6, 64)),
    "a2c2f_area4": lambda: (JE.A2C2f(128, n=1, a2=True, area=4), M.A2C2f(64, 128, 1, True, 4), (2, 8, 6, 64)),
    "a2c2f_residual": lambda: (JE.A2C2f(128, n=1, a2=True, area=4, residual=True, mlp_ratio=1.2),
                               M.A2C2f(128, 128, 1, True, 4, residual=True, mlp_ratio=1.2), (2, 8, 6, 128)),
    "a2c2f_c3k": lambda: (JE.A2C2f(64, n=2, a2=False), M.A2C2f(48, 64, 2, False), (2, 9, 8, 48)),
}


def load_module(pm, v):
    """A JAX module's variables into a port module strictly, through the
    graph bridge: both as row 0 of a graph."""
    state = state_dict_from_jax({k: {"model_0": t} for k, t in v.items() if t})
    pm.load_state_dict({k.removeprefix("model.0."): t for k, t in state.items()}, strict=True)
    return pm.to(memory_format=torch.channels_last)


@functools.cache
def jax_modules_run():
    """{name: (variables, input, eval output, train output, moved batch_stats)}
    of every MODULES case, all under one jax.jit (one compile, not one a case)."""
    cases = {}
    for name, make in MODULES.items():
        jm, _, shape = make()
        rng = np.random.default_rng(7)
        x = rng.normal(0, 1, shape).astype(np.float32)
        v = seeded_module(jm, jnp.asarray(x), rng)
        if "gamma" in v["params"]:  # away from its 0.01 init, so that the residual weighs
            v["params"]["gamma"] = rng.uniform(0.5, 1.5, v["params"]["gamma"].shape).astype(np.float32)
        cases[name] = (jm, v, x)

    def run(vs, xs):
        out = {}
        for name, (jm, _, _) in cases.items():
            train, moved = jm.apply(vs[name], xs[name], train=True, mutable=["batch_stats"])
            out[name] = (jm.apply(vs[name], xs[name], train=False), train, moved.get("batch_stats", {}))
        return out

    out = jax.jit(run)({k: c[1] for k, c in cases.items()}, {k: jnp.asarray(c[2]) for k, c in cases.items()})
    out = jax.tree.map(np.asarray, out)
    return {k: (v, x, *out[k]) for k, (_, v, x) in cases.items()}


def jax_module_run(name):
    """(variables, input, eval output, train output, moved batch_stats) of a MODULES case."""
    return jax_modules_run()[name]


@pytest.mark.parametrize("name", list(MODULES))
@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax(name, train):
    v, x, ref_eval, ref_train, moved = jax_module_run(name)
    pm = load_module(MODULES[name]()[1], v).train(train)
    with torch.no_grad():
        out = pm(to_torch(x))
    close(nhwc(out), ref_train if train else ref_eval, MOD_TOL)
    if train and moved:
        want = state_dict_from_jax({"batch_stats": {"model_0": moved}})
        got = pm.state_dict()
        stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
        assert stats
        for k in stats:
            close(got[k.removeprefix("model.0.")].numpy(), want[k].numpy(), MOD_TOL)


def test_pool_and_pad_rows_match_jax():
    """yolov3-tiny's rows: MaxPool2d(2, 2) on an odd map, ZeroPad2d([0, 1, 0,
    1]) then MaxPool2d(2, 1), and a padded MaxPool2d(3, 2, 1) (-inf past the
    edges), as parse_model builds them from torch.nn."""
    x = np.random.default_rng(3).normal(0, 1, (2, 9, 7, 4)).astype(np.float32)
    jx = jnp.asarray(x)
    refs = [JE.MaxPool2d(2, 2, 0).apply({}, jx),
            JE.MaxPool2d(2, 1, 0).apply({}, JE.ZeroPad2d((0, 1, 0, 1)).apply({}, jx)),
            JE.MaxPool2d(3, 2, 1).apply({}, jx)]
    ports = [torch.nn.MaxPool2d(2, 2, 0), torch.nn.Sequential(torch.nn.ZeroPad2d((0, 1, 0, 1)),
                                                               torch.nn.MaxPool2d(2, 1, 0)), torch.nn.MaxPool2d(3, 2, 1)]
    for pm, ref in zip(ports, refs):
        np.testing.assert_array_equal(nhwc(pm(to_torch(x))), np.asarray(ref))


def test_cblinear_cbfuse_match_jax():
    """Two CBLinears (groups (8, 16) and (4, 16)) fused onto a 10x6 map from
    5x3 (an integer factor) and 4x4 (factors 2.5 and 1.5): the nearest resize
    with half-pixel centres of jax.image.resize."""
    rng = np.random.default_rng(5)
    xa, xb = rng.normal(0, 1, (2, 5, 3, 12)).astype(np.float32), rng.normal(0, 1, (2, 4, 4, 12)).astype(np.float32)
    target = rng.normal(0, 1, (2, 10, 6, 16)).astype(np.float32)
    ja, jb, jf = JE.CBLinear((8, 16)), JE.CBLinear((4, 16)), JE.CBFuse((1, 1))
    va, vb = seeded_module(ja, jnp.asarray(xa), rng), seeded_module(jb, jnp.asarray(xb), rng)
    ref = jax.jit(lambda a, b, t: jf.apply({}, [ja.apply(va, a), jb.apply(vb, b), t]))(xa, xb, target)
    pa, pb = load_module(M.CBLinear(12, (8, 16)), va), load_module(M.CBLinear(12, (4, 16)), vb)
    with torch.no_grad():
        out = M.CBFuse((1, 1))([pa(to_torch(xa)), pb(to_torch(xb)), to_torch(target)])
    close(nhwc(out), ref, MOD_TOL)


def test_conv_transpose_flips_the_jax_kernel():
    """torch's ConvTranspose2d equals flax's ConvTranspose only with the
    kernel flipped in space and laid out (in, out, kh, kw): the bridge's
    `kernel_t`, both ways."""
    jm, pm, shape = MODULES["conv_transpose"]()
    v = jax_module_run("conv_transpose")[0]
    load_module(pm, v)
    k = v["params"]["conv_transpose"]["kernel"]  # (kh, kw, in, out)
    np.testing.assert_array_equal(pm.weight.detach().numpy(), k[::-1, ::-1].transpose(2, 3, 0, 1))
    assert not np.array_equal(k, k[::-1, ::-1])
    back = jax_variables_from_state(torch.nn.ModuleDict({"model": torch.nn.ModuleList([pm])}))
    np.testing.assert_array_equal(back["params"]["model_0"]["conv_transpose"]["kernel"], k)


# ---------------------------------------------------------------------------------------------------------------
# graphs


GRAPHS = ("yolov9t.yaml", "yolo12n.yaml", "yolov6n.yaml", "yolov3-tiny.yaml", "yolov8n-ghost-p6.yaml")
SLICE = ("yolov3.yaml", "yolov3-spp.yaml", "yolov3-tiny.yaml", "yolov5n.yaml", "yolov5n-p6.yaml", "yolov6n.yaml",
         "yolov8n.yaml", "yolov8n-p2.yaml", "yolov8n-p6.yaml", "yolov8n-ghost.yaml", "yolov8n-ghost-p2.yaml",
         "yolov8n-ghost-p6.yaml", "yolov9t.yaml", "yolov9s.yaml", "yolov9m.yaml", "yolov9c.yaml", "yolov9e.yaml",
         "yolo12n.yaml")


@functools.cache
def graph(cfg):
    """(JAX model, seeded variables, the port model loaded strictly) of a graph at 64 px."""
    jm = JaxDetectionModel(cfg)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(cfg, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


GRAPH_X = np.random.default_rng(64).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
# the graphs' JAX forward compiled at XLA's backend optimization level 0: a shorter compile, its convs summed in
# another order (far inside GRAPH_TOL, as tests/test_torch_obb.py measured)
QUICK = {"xla_backend_optimization_level": 0}
FUSED_REF = "yolov9t.yaml"  # the graph held to JAX's BN-folded forward, whose tree keeps RepConv's BatchNorms


@functools.cache
def jax_graphs_out():
    """{cfg: JAX's forward of the graph on GRAPH_X} for every one of GRAPHS,
    all under one jax.jit compiled at XLA's optimization level 0 (QUICK):
    on its BN-folded variables (fuse_variables) for FUSED_REF, else on the
    unfused ones. Folding is exact in real arithmetic, so the port's
    unfused and folded forwards are both held to it."""
    models = {cfg: graph(cfg)[0] for cfg in GRAPHS}
    vs = {cfg: fuse_variables(graph(cfg)[1]) if cfg == FUSED_REF else graph(cfg)[1] for cfg in GRAPHS}
    x = jnp.asarray(GRAPH_X)
    run = jax.jit(lambda vv, xx: {cfg: m.apply(vv[cfg], xx, train=False) for cfg, m in models.items()})
    out = run.lower(vs, x).compile(compiler_options=QUICK)(vs, x)
    return {cfg: (np.asarray(o), [np.asarray(f) for f in feats]) for cfg, (o, feats) in out.items()}


def jax_graph_out(cfg):
    """JAX's forward of one of GRAPHS on GRAPH_X (jax_graphs_out)."""
    return jax_graphs_out()[cfg]


def assert_graph_close(pm, ref, ref_feats):
    with torch.no_grad():
        out, feats = pm(to_torch(GRAPH_X))
    out = out.numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out[:, :4], ref[:, :4], rtol=GRAPH_TOL, atol=GRAPH_TOL * np.abs(ref[:, :4]).max())
    np.testing.assert_allclose(out[:, 4:], ref[:, 4:], rtol=GRAPH_TOL, atol=GRAPH_TOL)
    for f, rf in zip(feats, ref_feats):
        np.testing.assert_allclose(nhwc(f), rf, rtol=GRAPH_TOL, atol=GRAPH_TOL)


@pytest.mark.parametrize("cfg", GRAPHS)
@pytest.mark.parametrize("fused", [False, True])
def test_graph_matches_jax(cfg, fused):
    pm = graph(cfg)[2]
    assert_graph_close(copy.deepcopy(pm).fuse() if fused else pm, *jax_graph_out(cfg))


def test_graph_outputs_and_strides():
    """The decoded outputs' shapes at 64 px: two levels for yolov3-tiny,
    four (strides 8 to 64) for the P6 graph; no SwinBlock anywhere."""
    shapes = {cfg: jax_graph_out(cfg)[0].shape for cfg in GRAPHS}
    assert shapes["yolov3-tiny.yaml"] == (2, 84, 16 + 4) and shapes["yolov8n-ghost-p6.yaml"] == (2, 84, 64 + 16 + 4 + 1)
    assert graph("yolov8n-ghost-p6.yaml")[2].strides == (8, 16, 32, 64)
    assert not any(isinstance(m, M.SwinBlock) for cfg in GRAPHS for m in graph(cfg)[2].modules())


def test_rows_as_jax_builds_them():
    """yolov6n: the ReLU override on every Conv row (repeats included) but
    not inside SPPF or Detect, the transposed convs built at the width
    gain; yolo12n: A2C2f's heads and the YOLO11 Detect head; yolov9t:
    RepNCSPELAN4 with n from its args and RepConv branches unfolded by fuse()."""
    v6 = graph("yolov6n.yaml")[2]
    assert [m.act for m in v6.model[2]] == ["relu", "relu"] and v6.model[0].act == "relu"
    assert v6.model[9].cv1.act is True and v6.model[-1].cv2[0][0].act is True
    assert isinstance(v6.model[11], M.ConvTranspose2d) and tuple(v6.model[11].weight.shape) == (64, 64, 2, 2)
    y12 = graph("yolo12n.yaml")[2]
    assert y12.model[6].m[0][0].attn.num_heads == 2 and y12.model[6].m[0][0].attn.area == 4
    assert isinstance(y12.model[11].m[0], M.C3k) and isinstance(y12.model[-1].cv3[0][0], torch.nn.Sequential)
    v9 = copy.deepcopy(graph("yolov9t.yaml")[2])
    assert len(v9.model[4].cv2[0].m) == 3
    v9.fuse()
    reps = [m for m in v9.modules() if isinstance(m, M.RepConv)]
    assert v9.is_fused and len(reps) == 42 and all(r.conv1.bn is not None for r in reps)


@functools.cache
def slice_variables(cfg):
    """JAX's variables of a graph of the slice: the graph tests' seeded
    ones, or its shape_init with distinct values in each leaf (so that a
    transpose or a flip shows)."""
    if cfg in GRAPHS:
        return graph(cfg)[1]
    shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)
    return {k: jax.tree.map(lambda s: np.arange(np.prod(s.shape), dtype=np.float32).reshape(s.shape), shapes[k])
            for k in ("params", "batch_stats")}


@pytest.mark.parametrize("cfg", SLICE)
def test_every_graph_bridges_both_ways(cfg):
    """JAX's parameter count; every leaf of JAX's variables names one port
    tensor of its shape and the port has no other (strict load, into a
    model built on the meta device); the port's state written back as JAX
    variables is the same tree, bit for bit; every ungrouped conv takes
    conv_int8's geometry (int8_parity.assert_int8_geometry)."""
    v = slice_variables(cfg)
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    assert_int8_geometry(pm)
    assert sum(p.numel() for p in pm.parameters()) == sum(int(np.prod(np.shape(a))) for a in
                                                         jax.tree.leaves(v["params"]))
    pm.load_state_dict(state_dict_from_jax(v), strict=True, assign=True)
    back = jax_variables_from_state(pm)
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(back)
    assert want.keys() == got.keys()
    assert all(np.array_equal(want[k], got[k]) for k in want)


@pytest.mark.parametrize("cfg,params", [("yolov9c.yaml", 25_590_896), ("yolo12s.yaml", 9_284_080)])
def test_param_counts_of_the_full_width_graphs(cfg, params):
    """The two graphs the card runs at full width: the counts of JAX's
    shape_init without DFL's 16 fixed weights (yolo12s: tests/test_model_build.py)."""
    assert sum(p.numel() for p in DetectionModel(cfg, device="cpu").parameters()) == params


def test_fused_yolov9t_tree_reads_as_jax_fuses_it(tmp_path):
    """JAX's BN-folded yolov9t tree still holds RepConv's BatchNorms (its
    fuse_variables folds {conv, bn} pairs only): fused_state_from_jax reads
    it into a fused port model, which gives JAX's fused forward; the same
    model through YOLO.save(.ckpt) and YOLO(ckpt) again, and JAX's own
    YOLO.save of the folded tree read by YOLO(ckpt)."""
    from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO

    cfg = "yolov9t.yaml"
    v = graph(cfg)[1]
    fv = fuse_variables(v)
    assert "conv1_bn" in fv["params"]["model_4"]["cv2_csp"]["m_0_cv1"]
    assert "m_0_cv1" not in fv["fused"]["model_4"]["cv2_csp"] and "m_0_cv2" in fv["fused"]["model_4"]["cv2_csp"]
    ref = jax_graph_out(cfg)
    pm = DetectionModel(cfg, device="cpu").fuse()
    pm.load_state_dict(fused_state_from_jax(jax.tree.map(np.asarray, fv)), strict=True)
    assert_graph_close(pm, *ref)
    y = YOLO(cfg, device="cpu")
    y.model = pm
    y.save(str(tmp_path / "port.ckpt"))
    jy = JaxYOLO(cfg)
    jy.variables = fv
    jy.save(str(tmp_path / "jax.ckpt"))
    for path in ("port.ckpt", "jax.ckpt"):
        back = YOLO(str(tmp_path / path), device="cpu")
        assert back.is_fused
        assert_graph_close(back.model, *ref)


def test_yolo12n_ckpt_round_trip(tmp_path):
    """JAX's YOLO.save of yolo12n read by YOLO(ckpt), and the port's
    YOLO.save read back: both give JAX's forward."""
    from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO

    cfg = "yolo12n.yaml"
    jy = JaxYOLO(cfg)
    jy.variables = graph(cfg)[1]
    jy.save(str(tmp_path / "jax.ckpt"))
    y = YOLO(str(tmp_path / "jax.ckpt"), device="cpu")
    assert_graph_close(y.model, *jax_graph_out(cfg))
    y.save(str(tmp_path / "port.ckpt"))
    assert_graph_close(YOLO(str(tmp_path / "port.ckpt"), device="cpu").model, *jax_graph_out(cfg))


@pytest.mark.parametrize("strides", [(4, 8, 16, 32), (8, 16, 32, 64)])
def test_loss_on_four_levels_matches_jax(strides):
    """detection_loss on raw maps at four levels (the P2 and P6 grids at 64
    px, the assigner's plain version) against JAX's: the total, the three
    items and the grads of every map, as tests/test_torch_loss.py holds
    them at three."""
    rng = np.random.default_rng(sum(strides))
    b, g, nc, imgsz = 2, 6, 2, 64
    feats = [rng.normal(0, 1.5, (b, imgsz // s, imgsz // s, 64 + nc)).astype(np.float32) for s in strides]
    cls = rng.integers(0, nc, (b, g)).astype(np.int32)
    boxes = np.concatenate([rng.uniform(0.2, 0.8, (b, g, 2)), rng.uniform(0.05, 0.5, (b, g, 2))], -1)
    boxes = boxes.astype(np.float32)
    mask = (rng.random((b, g)) < 0.7).astype(np.float32)
    mask[0, 0] = 1.0

    def jloss(fs):
        return jax_detection_loss(fs, jnp.asarray(cls), jnp.asarray(boxes), jnp.asarray(mask), nc=nc,
                                  strides=strides)

    (jtotal, jitems), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))([jnp.asarray(f) for f in feats])
    tfeats = [torch.tensor(f).permute(0, 3, 1, 2).contiguous().requires_grad_() for f in feats]
    total, items = detection_loss(tfeats, torch.tensor(cls), torch.tensor(boxes), torch.tensor(mask), nc=nc,
                                  strides=strides)
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4, atol=1e-5)
    for name in ("box", "cls", "dfl"):
        np.testing.assert_allclose(getattr(items, name).item(), float(getattr(jitems, name)), rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    assert float(jitems.box) > 0
    for tf, jg in zip(tfeats, jgrads):
        np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


def test_bf16_model_holds_no_fp32_conv_weight():
    """_cast covers every conv the port builds: yolov6n's transposed convs
    and yolov9e's CBLinear convs are bf16 in a bf16 model, whose forward
    runs (Detect decodes in fp32)."""
    for cfg, kind in (("yolov6n.yaml", M.ConvTranspose2d), ("yolov9e.yaml", M.CBLinear)):
        m = DetectionModel(cfg, device="cpu", dtype=torch.bfloat16)
        convs = [c for c in m.modules() if isinstance(c, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
        assert any(isinstance(c, kind) for c in m.modules())
        assert convs and all(c.weight.dtype == torch.bfloat16 for c in convs)
    m = DetectionModel("yolov6n.yaml", device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        out = m(torch.rand(1, 3, 64, 64))[0]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_quantize_model_refuses_the_new_rows():
    """quantize_model takes yolov9t now (its rows were refused until the JAX
    gate was ported): every Conv quantized but RepConv's two branches, raw
    convs in JAX; what it refuses, before the calibration sweep, is an
    ungrouped conv whose stride or padding differ between the axes, which
    conv_int8 cannot run."""
    frames = [np.zeros((1, 64, 64, 3), np.uint8)]
    m = DetectionModel("yolov9t.yaml", device="cpu", param_dtype=torch.float32).fuse()
    quantize_model(m, frames)
    reps = [r for r in m.modules() if isinstance(r, M.RepConv)]
    branches = {id(c) for r in reps for c in (r.conv1, r.conv2)}
    convs = [c for c in m.modules() if isinstance(c, M.Conv)]
    assert len(reps) == 42 and all(c.w_int8 is None for c in convs if id(c) in branches)
    assert all(c.runs_int8 for c in convs if id(c) not in branches)
    bad = DetectionModel("yolov9t.yaml", device="cpu", param_dtype=torch.float32).fuse()
    bad.model[1].conv.stride = (2, 1)
    with pytest.raises(ValueError, match=r"model\.1 has stride \(2, 1\)"):
        quantize_model(bad, frames)
    assert not any(getattr(c, "calib", None) for c in bad.modules()) and not Q.is_quantized(bad)


INT8_FRAMES = np.random.default_rng(8).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)


@functools.cache
def int8_run(cfg):
    """(port, JAX) int8 paths of a graph's seeded weights on INT8_FRAMES (one batch), JAX's forward on GRAPH_X."""
    jm, v, pm = graph(cfg)
    return port_int8(pm, INT8_FRAMES), jax_int8(jm, v, INT8_FRAMES, GRAPH_X)


def test_int8_calibration_matches_jax():
    assert_calibration_close(*int8_run("yolov9t.yaml"))


def test_int8_quant_state_matches_jax():
    assert_quant_state_close(*int8_run("yolov9t.yaml"))


def test_int8_graph_matches_jax():
    """yolov9t's int8 graph with JAX's quant state carried in against JAX's
    int8 graph: the decoded boxes, the class scores and each raw map within
    OUT_TOL (tests/int8_parity.py)."""
    port, ref = int8_run("yolov9t.yaml")
    m = int8_with_jax_state(port, ref)
    assert sum(c.runs_int8 for c in m.modules() if isinstance(c, M.Conv)) == 137
    with torch.no_grad():
        out, feats = m(to_torch(GRAPH_X))
    rout, rfeats = ref["out"]
    assert_out_close(out[:, :4].numpy(), rout[:, :4])
    assert_out_close(out[:, 4:].numpy(), rout[:, 4:])
    for f, rf in zip(feats, rfeats):
        assert_out_close(nhwc(f), rf)


@pytest.mark.parametrize("cfg", ["yolov6n.yaml", "yolov8n-ghost-p6.yaml", "yolo12n.yaml"])
def test_int8_gate_matches_jax(cfg):
    """The convs quantize_model calibrates are the ones JAX's calibration
    pass records (jax.eval_shape of it: no compile): yolov6n's transposed
    convs, GhostConv's cheap op and AAttn's pe as JAX has them; the int8
    forward runs, finite, with its grouped convs and transposed convs float."""
    jm, v, pm = graph(cfg)
    fv = fuse_variables(v)
    shapes = jax.eval_shape(lambda vv, x: jm.apply(vv, x, train=False, mutable=["calib"])[1]["calib"], fv,
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = to_port_calib(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    m = copy.deepcopy(pm).fuse()
    got = Q.calibrate(m, [INT8_FRAMES])
    assert got.keys() == want.keys() and all(got[k].keys() == want[k].keys() for k in want)
    quantize_model(m, [INT8_FRAMES])
    convs = [c for c in m.modules() if isinstance(c, M.Conv)]
    assert all(c.w_int8 is not None for c in convs) and all(c.runs_int8 == (c.conv.groups == 1) for c in convs)
    assert any(c.conv.groups > 1 for c in convs) == (cfg != "yolov6n.yaml")
    with torch.no_grad():
        out = m(to_torch(GRAPH_X))[0]
    assert out.shape == jax_graph_out(cfg)[0].shape and torch.isfinite(out).all()


@pytest.mark.parametrize("name,path", [("yolov8n-ghost-p6.yaml", "v8/yolov8-ghost-p6.yaml"),
                                       ("yolov6n.yaml", "v6/yolov6.yaml"), ("yolo12s.yaml", "12/yolo12.yaml"),
                                       ("yolov9c.yaml", "v9/yolov9c.yaml"), ("yolov3-tiny.yaml", "v3/yolov3-tiny.yaml"),
                                       ("yolov10n.yaml", "v10/yolov10n.yaml")])
def test_yaml_names_resolve_to_the_port_copies(name, path):
    from improving_yolov8_cbam_swinblock_tpu.nn.tasks import yaml_model_load as jax_yaml_model_load
    from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import CFG_DIR, yaml_model_load

    d, jd = yaml_model_load(name), jax_yaml_model_load(name)
    assert d["yaml_file"] == str(CFG_DIR / "models" / path)
    assert d.get("scale", "") == jd.get("scale", "")
    assert {k: d[k] for k in ("backbone", "head")} == {k: jd[k] for k in ("backbone", "head")}
