"""YOLO-World in the port vs the JAX package, on the same weights and inputs.

Modules, fp32, on seeded numpy variables carried in by the weight bridge
(kernels, norms, biases and statistics random; the contrastive heads'
logit scales set): MaxSigmoidAttnBlock with an `ec` conv and heads of
ec // nh = 4 scored over sqrt(c2 // nh) = sqrt(8) (the JAX package's
split), and without one, with its per-head scale; C2fAttn with two
bottlenecks; ImagePoolingAttn over three levels of 7x5, 4x4 and 2x3 (sizes
that 3 does not divide: its adaptive max pool's windows, which are also
held alone bit for bit); ContrastiveHead; BNContrastiveHead in eval and in
training (its output and its moved statistics, flax's momentum and biased
variance); WorldDetect with either head, scored at 5 prompts for a YAML nc
of 3, in eval: each within MOD_TOL (1e-5) of the largest magnitude. The
JAX package's tiny World graph (tests/test_world.py TINY_WORLD) at 64 px,
at 5 prompts: the eval prediction within GRAPH_TOL, the validator's
detections against the JAX validator's, and the train micro-step's loss
items and every parameter's gradient (the detect loss at nc = 5, the
assigner's plain version on the CPU) within TRAIN_TOL. All the JAX sides
run under one jax.jit (the validator's under its own).

The graph: both World YAMLs at scale n on the meta device, name for name
and shape for shape against jax.eval_shape of JAX's init; their parameter
counts at scale s (the reference's 13,383,496 and 12,759,880 less DFL's
16). set_classes: the features equal JAX's bit for bit, nc, names and the
output width follow, the weights stay; embeddings set by hand. The seeded
init's head equals JAX's flax init (box bias 1, embedding bias 0,
contrastive bias -10, logit scale log(1 / 0.07) or -1). The bridge both
ways bit for bit; a .ckpt round trip; a World model saved with its names
and reloaded scores against those names' features (.ckpt and .pt: the JAX
package keeps its placeholders, ROADMAP.md Queue 3), a .pt keeps
embeddings set by hand; YOLOWorld's default graph and its refusal; predict
with prompt names; YOLO.train on a synthetic dataset takes the data's
names' features (K2's plain version) and best.pt reloads them.
"""

import copy
import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu import YOLO as JaxYOLO
from improving_yolov8_cbam_swinblock_tpu.engine.validator import DetectionValidator as JaxValidator
from improving_yolov8_cbam_swinblock_tpu.nn import modules_world as JW
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu.utils.loss import detection_loss as jax_detection_loss
from improving_yolov8_cbam_swinblock_tpu.utils.text_model import encode_texts as jax_encode_texts
from improving_yolov8_cbam_swinblock_tpu_torch import YOLO, DetectionModel, YOLOWorld
from improving_yolov8_cbam_swinblock_tpu_torch.engine.validator import DetectionValidator
from improving_yolov8_cbam_swinblock_tpu_torch.nn import modules_world as W
from improving_yolov8_cbam_swinblock_tpu_torch.ops.tal import tal_assign_cuda
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import jax_variables_from_state, state_dict_from_jax
from improving_yolov8_cbam_swinblock_tpu_torch.utils.loss import detection_loss
from improving_yolov8_cbam_swinblock_tpu_torch.utils.text_model import encode_texts
from tests.test_torch_model import randomize, seeded_variables
from tests.test_torch_yolo11 import close, nhwc, to_torch
from tests.test_world import TINY_WORLD
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
MOD_TOL = 1e-5
GRAPH_TOL = 2e-3
TRAIN_TOL = 1e-3
PROMPTS = ["person", "cat", "a red bus", "dog", "kite"]
FRAMES = np.random.default_rng(23).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
GT = {"cls": np.array([[0, 3, 1, 0], [4, 2, 0, 0]], np.int32),
      "bboxes": np.array([[[0.3, 0.3, 0.3, 0.25], [0.7, 0.6, 0.35, 0.4], [0.5, 0.5, 0.5, 0.5], [0, 0, 0, 0]],
                          [[0.5, 0.4, 0.6, 0.5], [0.25, 0.75, 0.2, 0.3], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32),
      "mask": np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.float32)}
LEVELS = ((7, 5, 8), (4, 4, 12), (2, 3, 16))  # (h, w, c) of ImagePoolingAttn's and WorldDetect's inputs


def module_cases():
    """{name: (JAX module, port module, inputs: NHWC maps and texts, train)}."""
    rng = np.random.default_rng(40)
    r = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    maps = [r(2, h, w, c) for h, w, c in LEVELS]
    return {
        "maxsigmoid": (JW.MaxSigmoidAttnBlock(16, nh=2, ec=8, gc=12), W.MaxSigmoidAttnBlock(12, 16, nh=2, ec=8, gc=12),
                       (r(2, 5, 6, 12), r(2, 4, 12)), False),
        "maxsigmoid_scale": (JW.MaxSigmoidAttnBlock(16, nh=4, ec=12, gc=12, scale=True),
                             W.MaxSigmoidAttnBlock(12, 16, nh=4, ec=12, gc=12, scale=True),
                             (r(2, 5, 6, 12), r(2, 3, 12)), False),
        "c2fattn": (JW.C2fAttn(24, n=2, ec=8, nh=2, gc=12, shortcut=True),
                    W.C2fAttn(16, 24, n=2, ec=8, nh=2, gc=12, shortcut=True), (r(2, 6, 5, 16), r(2, 4, 12)), False),
        "ipa": (JW.ImagePoolingAttn(ec=16, ch=tuple(c for _, _, c in LEVELS), ct=12, nh=4, k=3),
                W.ImagePoolingAttn(16, [c for _, _, c in LEVELS], ct=12, nh=4, k=3), (maps, r(2, 4, 12)), False),
        "contrastive": (JW.ContrastiveHead(), W.ContrastiveHead(), (r(2, 5, 6, 16), r(2, 4, 16)), False),
        "bn_contrastive": (JW.BNContrastiveHead(16), W.BNContrastiveHead(16), (r(2, 5, 6, 16), r(2, 4, 16)), False),
        "bn_contrastive_train": (JW.BNContrastiveHead(16), W.BNContrastiveHead(16), (r(2, 5, 6, 16), r(2, 4, 16)),
                                 True),
        "world_detect": (JW.WorldDetect(nc=3, embed=16, ch=tuple(c for _, _, c in LEVELS)),
                         W.WorldDetect(3, [c for _, _, c in LEVELS], embed=16), (maps, r(2, 5, 16)), False),
        "world_detect_bn": (JW.WorldDetect(nc=3, embed=16, with_bn=True, ch=tuple(c for _, _, c in LEVELS)),
                            W.WorldDetect(3, [c for _, _, c in LEVELS], embed=16, with_bn=True), (maps, r(2, 5, 16)),
                            False),
    }


def seeded(jm, args, rng):
    """A JAX module's variables from its abstract init (no compile): kernels
    uniform with the conv init's variance, then randomize(); each logit
    scale drawn too."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args))

    def leaf(path, s):
        if path[-1].key == "logit_scale":
            return np.float32(rng.uniform(-0.5, 1.0))
        if s.ndim < 2:
            return np.zeros(s.shape, np.float32)
        bound = np.sqrt(1.0 / np.prod(s.shape[:-1]))
        return rng.uniform(-bound, bound, s.shape).astype(np.float32)

    return randomize(jax.tree_util.tree_map_with_path(leaf, shapes), rng)


def jax_inputs(args):
    return [[jnp.asarray(a) for a in x] if isinstance(x, list) else jnp.asarray(x) for x in args]


@functools.cache
def tiny_jax():
    jm = JaxDetectionModel(copy.deepcopy(TINY_WORLD))
    jm.set_classes(PROMPTS)
    return jm, seeded_variables(jm, 64, np.random.default_rng(41))


@pytest.fixture(scope="module")
def jax_side():
    """Every module's outputs, the adaptive pool on a 7x5 map, the tiny
    graph's eval prediction and its train loss items and gradients, under one jax.jit."""
    rng = np.random.default_rng(42)
    cases = module_cases()
    variables = {k: seeded(jm, jax_inputs(args), rng) for k, (jm, _, args, _) in cases.items()}
    jm, gv = tiny_jax()
    x = jnp.asarray(FRAMES.astype(np.float32) / 255.0)
    pool_x = rng.normal(0, 1, (2, 7, 5, 3)).astype(np.float32)

    def run(vs, gvar):
        out = {}
        for k, (m, _, args, train) in cases.items():
            if train:
                y, mut = m.apply(vs[k], *jax_inputs(args), train=True, mutable=["batch_stats"])
                out[k] = (y, mut["batch_stats"])
            else:
                out[k] = m.apply(vs[k], *jax_inputs(args), train=False)
        out["world_detect"] = out["world_detect"][0]
        out["world_detect_bn"] = out["world_detect_bn"][0]
        out["pool"] = JW._adaptive_max_pool(jnp.asarray(pool_x), 3)
        out["graph"] = jm.apply(gvar, x, train=False)[0]

        def loss_fn(params):
            feats, _ = jm.apply({"params": params, "batch_stats": gvar["batch_stats"]}, x, train=True,
                                mutable=["batch_stats"])
            total, items = jax_detection_loss(tuple(feats), jnp.asarray(GT["cls"]), jnp.asarray(GT["bboxes"]),
                                              jnp.asarray(GT["mask"]), nc=len(PROMPTS), strides=tuple(jm.strides))
            return total, jnp.stack([items.box, items.cls, items.dfl])

        (total, items), grads = jax.value_and_grad(loss_fn, has_aux=True)(gvar["params"])
        out["train"] = {"total": total, "items": items, "grads": grads}
        return out

    out = jax.tree.map(np.asarray, jax.jit(run)(variables, gv))
    return {"vars": variables, "out": out, "pool_x": pool_x}


def port_module(pm, v):
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return pm.eval().to(memory_format=torch.channels_last)


def port_inputs(args):
    """NHWC maps -> NCHW tensors; texts (B, K, C) as they are."""
    def one(a):
        return to_torch(a) if a.ndim == 4 else torch.from_numpy(a)

    return [[one(a) for a in x] if isinstance(x, list) else one(x) for x in args]


@functools.cache
def tiny_port_model():
    return DetectionModel(copy.deepcopy(TINY_WORLD), device="cpu")


def tiny_loaded():
    """The port's tiny World graph with the JAX variables, at the five prompts."""
    pm = copy.deepcopy(tiny_port_model())
    pm.load_state_dict(state_dict_from_jax(tiny_jax()[1]), strict=True)
    pm.set_classes(PROMPTS)
    return pm


@pytest.mark.parametrize("name", ["maxsigmoid", "maxsigmoid_scale", "c2fattn", "ipa", "contrastive",
                                  "bn_contrastive", "bn_contrastive_train", "world_detect", "world_detect_bn"])
def test_module_matches_jax(jax_side, name):
    """Each module within MOD_TOL of JAX's on the same weights and inputs; a
    BNContrastiveHead in training also moves its statistics as JAX's; a
    WorldDetect's decode has 4 + 5 prompts' channels for its YAML nc of 3."""
    _, pm, args, train = module_cases()[name]
    pm = port_module(pm, jax_side["vars"][name])
    ref = jax_side["out"][name]
    if train:
        pm.train()
        out = pm(*port_inputs(args))
        close(out.detach().permute(0, 2, 3, 1).numpy(), ref[0], MOD_TOL)
        moved = state_dict_from_jax({"batch_stats": ref[1]})
        for k in ("norm.running_mean", "norm.running_var"):
            close(pm.state_dict()[k].numpy(), moved[k].numpy(), MOD_TOL)
        return
    with torch.no_grad():
        out = pm(*port_inputs(args))
    if name.startswith("world_detect"):
        assert out[0].shape == ref.shape == (2, 4 + 5, sum(h * w for h, w, _ in LEVELS))
        close(out[0].numpy(), ref, MOD_TOL)
    elif name == "ipa" or name.endswith("contrastive"):
        got = out.numpy() if name == "ipa" else out.permute(0, 2, 3, 1).numpy()
        assert got.shape == ref.shape
        close(got, ref, MOD_TOL)
    else:
        close(nhwc(out), ref, MOD_TOL)


def test_adaptive_max_pool_windows_match_jax(jax_side):
    """A 7x5 map pooled to 3x3: JAX's slices and the port's windows (nn.AdaptiveMaxPool2d's), bit for bit."""
    got = W._adaptive_max_pool(to_torch(jax_side["pool_x"]), 3)
    np.testing.assert_array_equal(nhwc(got), jax_side["out"]["pool"])


def test_tiny_graph_eval_and_validator_match_jax(jax_side):
    """The tiny graph at five prompts: (B, 4 + 5, A) within GRAPH_TOL of
    JAX's; the validator's NMS rows against the JAX validator's."""
    pm = tiny_loaded()
    with torch.no_grad():
        y, _ = pm(to_torch(FRAMES.astype(np.float32) / 255.0))
    ref = jax_side["out"]["graph"]
    assert pm.is_world and pm.nc == 5 and y.shape == ref.shape == (2, 9, 84)
    close(y.numpy(), ref, GRAPH_TOL)
    jm, gv = tiny_jax()
    args = SimpleNamespace(imgsz=64, max_det=300, plots=False, save_json=False)
    want = np.asarray(JaxValidator(jm, loader=None, args=args)._forward_nms(gv, jnp.asarray(FRAMES)))
    got = DetectionValidator(pm, None, args).forward_nms(FRAMES)
    assert got.shape == want.shape
    keep = want[..., 4] > 0.01  # rows well above the conf floor: their order does not rest on a near tie
    close(got[keep], want[keep], GRAPH_TOL)


def test_train_micro_step_matches_jax(jax_side):
    """The tiny graph in training at five prompts, batch 2 at 64 px: the
    detect loss (the assigner's plain version on the CPU: no K2 launch),
    its total and items within TRAIN_TOL of JAX's and every parameter's
    gradient within TRAIN_TOL of that tensor's largest magnitude (fp32 sums
    in another order through training BatchNorms at batch 2), or within
    1e-6 of the largest gradient where it is rounding noise (the attention
    keys' bias, which the softmax cancels)."""
    pm = tiny_loaded().train()
    before = tal_assign_cuda.launches
    feats = pm(to_torch(FRAMES.astype(np.float32) / 255.0))
    total, items = detection_loss(feats, torch.from_numpy(GT["cls"]), torch.from_numpy(GT["bboxes"]),
                                  torch.from_numpy(GT["mask"]), nc=5, strides=pm.strides)
    total.backward()
    assert tal_assign_cuda.launches == before
    ref = jax_side["out"]["train"]
    np.testing.assert_allclose(float(total.detach()), float(ref["total"]), rtol=TRAIN_TOL)
    np.testing.assert_allclose(torch.stack(list(items)).numpy(), ref["items"], rtol=TRAIN_TOL)
    want = {k: g.numpy() for k, g in state_dict_from_jax({"params": ref["grads"]}).items()}
    params = dict(pm.named_parameters())
    assert set(want) == set(params)
    floor = 1e-6 * max(float(np.abs(g).max()) for g in want.values())  # a gradient that is rounding noise
    for name, g in want.items():
        atol = max(TRAIN_TOL * float(np.abs(g).max()), floor)
        np.testing.assert_allclose(params[name].grad.numpy(), g, rtol=0, atol=atol, err_msg=name)
    assert float(params["model.5.attn.gl.weight"].grad.abs().sum()) > 0  # the text-guided attention learns


@pytest.mark.parametrize("cfg", ["yolov8n-world.yaml", "yolov8n-worldv2.yaml"])
def test_yaml_builds_on_meta_name_for_name(cfg):
    """The port's YAML is the JAX package's, byte for byte; scale n on the
    meta device against jax.eval_shape of JAX's init: the same names and
    shapes (a strict load); at scale s the reference's parameter counts less
    DFL's 16 fixed weights."""
    with torch.device("meta"):
        pm = DetectionModel(cfg, device="meta")
    port_file = Path(pm.yaml["yaml_file"])
    jax_dir = Path(__file__).resolve().parent.parent / "improving_yolov8_cbam_swinblock_tpu/cfg/models/v8"
    assert port_file.read_bytes() == (jax_dir / port_file.name).read_bytes()
    assert pm.is_world and pm.task == "detect" and pm.nc == 80
    shapes = JaxDetectionModel(cfg).shape_init(imgsz=64)
    state = state_dict_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                             {k: shapes[k] for k in ("params", "batch_stats")}))
    assert state.keys() == pm.state_dict().keys()
    assert all(tuple(state[k].shape) == tuple(t.shape) for k, t in pm.state_dict().items())
    pm.load_state_dict(state, strict=True, assign=True)
    with torch.device("meta"):
        s = DetectionModel(cfg.replace("v8n", "v8s"), device="meta")
    assert sum(p.numel() for p in s.parameters()) == {"yolov8n-world.yaml": 13383496,
                                                      "yolov8n-worldv2.yaml": 12759880}[cfg] - 16


def test_set_classes_swaps_the_text_and_keeps_the_weights():
    """set_classes: txt_feats equal JAX's bit for bit (the hash projection),
    nc, names and the output width follow, the weights do not move; the
    seeded model starts at JAX's placeholder prompts "0" to "nc - 1";
    embeddings given are taken as they are; a count mismatch and a graph
    without a World head raise."""
    pm = copy.deepcopy(tiny_port_model())
    np.testing.assert_array_equal(pm.txt_feats.numpy(), tiny_jax_placeholders())
    before = {k: t.clone() for k, t in pm.state_dict().items()}
    pm.set_classes(PROMPTS)
    assert pm.nc == 5 and pm.names == dict(enumerate(PROMPTS)) and pm.txt_feats.dtype == torch.float32
    np.testing.assert_array_equal(pm.txt_feats.numpy(), jax_encode_texts(PROMPTS)[None])
    assert all(torch.equal(before[k], t) for k, t in pm.state_dict().items())
    assert "txt_feats" not in pm.state_dict()
    x = to_torch(FRAMES.astype(np.float32) / 255.0)
    with torch.no_grad():
        assert pm(x)[0].shape == (2, 9, 84)
        e = np.random.default_rng(0).normal(0, 1, (2, 512)).astype(np.float32)
        pm.set_classes(["a", "b"], embeddings=e)
        assert pm(x)[0].shape == (2, 6, 84)
    np.testing.assert_array_equal(pm.txt_feats[0].numpy(), e)
    with pytest.raises(ValueError, match="3 classes"):
        pm.set_classes(["a", "b", "c"], embeddings=e)
    with pytest.raises(ValueError, match="World"):
        DetectionModel("yolov8n.yaml", device="meta").set_classes(["a"])


def tiny_jax_placeholders():
    return jax_encode_texts([str(i) for i in range(TINY_WORLD["nc"])])[None]


def test_seeded_head_equals_jax_flax_init():
    """The seeded World heads' constant leaves equal those JAX's flax init
    gives: box bias 1, embedding bias 0, contrastive bias -10 and logit scale
    log(1 / 0.07) (-1 with BatchNorm), BatchNorm scale 1 and bias 0, the
    attention's per-head bias 0. One jax.jit of the inits, only those leaves returned."""
    ch = tuple(c for _, _, c in LEVELS)
    heads = {bn: W.WorldDetect(3, list(ch), embed=16, with_bn=bn == "bn") for bn in ("plain", "bn")}
    for h in heads.values():
        from improving_yolov8_cbam_swinblock_tpu_torch.nn.tasks import init_weights

        init_weights(h, torch.Generator().manual_seed(0))
    attn = W.MaxSigmoidAttnBlock(12, 16, nh=2, ec=8, gc=12)
    xs = [jnp.zeros((1, h, w, c)) for h, w, c in LEVELS]
    text = jnp.zeros((1, 5, 16))

    def leaves():
        out = {}
        for bn in ("plain", "bn"):
            v = JW.WorldDetect(nc=3, embed=16, with_bn=bn == "bn", ch=ch).init(jax.random.PRNGKey(0), xs, text)
            out[bn] = {"/".join(p.key for p in k): a for k, a in jax.tree_util.tree_flatten_with_path(v["params"])[0]
                       if np.ndim(a) < 2 and (k[-2].key.startswith("cv4") or k[-2].key in ("norm", "cv2_0_2")
                                              or k[-2].key.endswith("_2"))}
        v = JW.MaxSigmoidAttnBlock(16, nh=2, ec=8, gc=12).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 12)),
                                                               jnp.zeros((1, 3, 12)))
        out["attn"] = v["params"]["bias"]
        return out

    ref = jax.jit(leaves)()
    for bn, head in heads.items():
        flat = {}
        for path, a in ref[bn].items():
            *scopes, leaf = path.split("/")
            node = flat
            for key in scopes:
                node = node.setdefault(key, {})
            node[leaf] = np.asarray(a)
        got = state_dict_from_jax({"params": flat})
        assert len(got) == (18 if bn == "bn" else 12)
        for name, want in got.items():
            assert torch.equal(head.state_dict()[name], want), (bn, name)
    assert torch.equal(attn.bias.detach(), torch.from_numpy(np.array(ref["attn"])))


def test_bridge_both_ways_ckpt_round_trip_and_names_on_reload(tmp_path):
    """The World names map both ways bit for bit (`attn.gl`, `attn.ec`,
    `attn.proj_conv`, `attn.bias`, `query.0`, `query.1`, `projections.0`,
    `proj`, `cv4.0.bias`, `cv4.0.logit_scale`); a .ckpt written and read
    back gives the same state. A World model with named classes saved as
    .ckpt or .pt and reloaded scores against its names' features, where the
    JAX package's YOLO(path) keeps the placeholders of its YAML's nc (ROADMAP
    Queue 3); a .pt also keeps embeddings set by hand."""
    pm = tiny_loaded()
    names = set(pm.state_dict())
    assert {"model.5.attn.gl.weight", "model.8.attn.ec.conv.weight", "model.5.attn.proj_conv.bn.running_var",
            "model.5.attn.bias", "model.6.query.0.weight", "model.6.query.1.bias", "model.6.key.1.weight",
            "model.6.value.0.bias", "model.6.projections.2.weight", "model.6.proj.weight", "model.9.cv4.0.bias",
            "model.9.cv4.2.logit_scale", "model.9.cv3.1.2.bias"} <= names
    v = tiny_jax()[1]
    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(a) for k, a in jax.tree_util.tree_flatten_with_path(t)[0]}
    want, got = flat({k: v[k] for k in ("params", "batch_stats")}), flat(jax_variables_from_state(pm))
    assert want.keys() == got.keys() and all(np.array_equal(want[k], got[k]) for k in want)
    y = YOLO(copy.deepcopy(TINY_WORLD), device="cpu")
    y.model.load_state_dict(pm.state_dict())
    y.set_classes(["cat", "dog", "bus"])
    y.save(str(tmp_path / "w.ckpt"))
    back = YOLO(str(tmp_path / "w.ckpt"), device="cpu")
    assert all(torch.equal(back.model.state_dict()[k], t) for k, t in pm.state_dict().items())
    assert back.names == {0: "cat", 1: "dog", 2: "bus"}
    np.testing.assert_array_equal(back.model.txt_feats.numpy(), encode_texts(["cat", "dog", "bus"])[None])
    jy = JaxYOLO(str(tmp_path / "w.ckpt"))  # the JAX package's reload: names restored, features not
    assert jy.model.names == {0: "cat", 1: "dog", 2: "bus"}
    np.testing.assert_array_equal(jy.model.txt_feats, tiny_jax_placeholders())
    assert not np.array_equal(jy.model.txt_feats, back.model.txt_feats.numpy())
    y.save(str(tmp_path / "w.pt"))
    np.testing.assert_array_equal(YOLO(str(tmp_path / "w.pt"), device="cpu").model.txt_feats.numpy(),
                                  back.model.txt_feats.numpy())
    e = np.random.default_rng(1).normal(0, 1, (1, 2, 512)).astype(np.float32)
    y.model.set_classes(["thing-a", "thing-b"], embeddings=e)
    y.save(str(tmp_path / "hand.pt"))
    hand = YOLO(str(tmp_path / "hand.pt"), device="cpu")
    assert hand.names == {0: "thing-a", 1: "thing-b"}
    np.testing.assert_array_equal(hand.model.txt_feats.numpy(), e)


def test_facade_predicts_with_prompt_names():
    """YOLOWorld's default graph is yolov8s-worldv2 (built on the meta
    device) and it refuses a graph without WorldDetect; YOLO.set_classes on
    the tiny graph names its Results by the prompts and changes what
    predict keeps."""
    with torch.device("meta"):
        w = YOLOWorld(device="meta")
    assert w.model.is_world and w.model.yaml["yaml_file"].endswith("yolov8-worldv2.yaml")
    assert w.model.meta["scale"] == "s"
    with pytest.raises(ValueError, match="WorldDetect"), torch.device("meta"):
        YOLOWorld("yolov8n.yaml", device="meta")
    y = YOLO(copy.deepcopy(TINY_WORLD), device="cpu")
    y.model.load_state_dict(tiny_loaded().state_dict())
    y.set_classes(["thing-a", "thing-b"])
    res = y.predict(np.random.default_rng(0).integers(0, 256, (96, 72, 3), dtype=np.uint8), imgsz=64, conf=0.01,
                    verbose=False)
    assert len(res) == 1 and res[0].names == {0: "thing-a", 1: "thing-b"} and len(res[0]) > 0
    assert set(res[0].boxes.cls.astype(int).tolist()) <= {0, 1}


def test_train_takes_the_data_names_and_best_reloads_them(tmp_path, monkeypatch):
    """YOLO.train on a synthetic dataset (2 micro-steps, no val): the model
    scores against its data's names' features before the first step (as the
    JAX trainer's set_classes), the loss has as many classes, and last.pt
    reloads with the same names and features."""
    from tests.synth_data import make_synth_dataset

    monkeypatch.setitem(PS.SETTINGS, "tensorboard", False)
    data = make_synth_dataset(tmp_path / "synth", n_train=4, n_val=2, imgsz=64, nc=3)
    y = YOLO(copy.deepcopy(TINY_WORLD), device="cpu")
    y.train(data=str(data), epochs=1, batch=2, nbs=2, imgsz=64, device="cpu", project=str(tmp_path / "runs"),
            val=False, plots=False, workers=0)
    names = y.trainer.model.names
    assert y.trainer.model.nc == len(names) == 3
    np.testing.assert_array_equal(y.trainer.model.txt_feats.numpy(), encode_texts(list(names.values()))[None])
    last = YOLO(str(y.trainer.wdir / "last.pt"), device="cpu")
    assert last.names == names
    np.testing.assert_array_equal(last.model.txt_feats.numpy(), y.trainer.model.txt_feats.numpy())
