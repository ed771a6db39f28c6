"""YAML graph compiler and the detection model of the PyTorch port.

`yaml_model_load` resolves `yolov8s-cbam-swin.yaml` to the base file plus
scale 's' (and `yolo11m-cbam-swin.yaml` to the YOLO11 graph at scale 'm',
`yolov8n-ghost-p6.yaml` to the ghost P6 graph at 'n'); `parse_model` builds
the rows of a detect graph that ends in `Detect` into torch modules (each
with its row `.i`, its inputs `.f` and its YAML name `.type`) with the
reference's channel bookkeeping (width and depth gains or the legacy
depth_multiple and width_multiple, make_divisible, pass-through channels
for CBAM and SwinBlock), repeats a row of a module without its own depth as
an nn.Sequential, applies a YAML-level ReLU `activation` to the Conv rows as
the JAX package does, and derives each layer's stride from the graph
instead of a probe forward. It builds the fork's graphs and YOLOv3, v5, v6,
the v8 P2, P6 and ghost graphs, YOLOv9, YOLOv10 (its NMS-free `v10Detect`
head: `DetectionModel.end2end`) and YOLO11/12, the segmentation graphs
that end in `Segment` (`DetectionModel.task` "segment") and the pose graphs
that end in `Pose` (task "pose", a row whose `kpt_shape` argument names
the YAML's own key, as the JAX package resolves it); a row it does not
know (the rows no packaged YAML of these uses) raises KeyError naming it.
`DetectionModel` also
runs the JAX package's test-time augmentation (`predict_augment`), gives pooled layer
embeddings (`embed`) and every layer's feature maps (`features`), and
`EnsembleModel` serves several detection models behind one NMS.
"""

from __future__ import annotations

import ast
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
import yaml

from ..utils.device import select_device
from . import modules as M

CFG_DIR = Path(__file__).resolve().parent.parent / "cfg"

def _arg(a: list, i: int, default):
    return a[i] if len(a) > i else default


def _conv_args(a: list) -> dict:
    """A Conv row's [c2, k, s, p] (yolov5's stem gives p); the long form's g, d and act raise."""
    if len(a) > 4:
        raise KeyError(f"Conv rows with groups, dilation or an activation ({a}) are not built by the port")
    kw = {"k": _arg(a, 1, 1), "s": _arg(a, 2, 1)}
    return {**kw, "p": a[3]} if len(a) > 3 and a[3] is not None else kw


# YAML rows whose output channels are width-scaled: name -> (module, its
# keyword arguments past c1 and c2 from the row's args, whether the row's
# repeat is the module's own depth n). A row of another module repeats as an
# nn.Sequential. C3k2 and A2C2f, which also read the scale, have branches of
# their own in parse_model; so do the routing, pooling and head rows. Any
# other name raises KeyError.
BASE_MODULES = {
    "Conv": (M.Conv, _conv_args, False),
    "Bottleneck": (M.Bottleneck, lambda a: {"shortcut": _arg(a, 1, True)}, False),
    "C2f": (M.C2f, lambda a: {"shortcut": _arg(a, 1, False)}, True),
    "C3": (M.C3, lambda a: {"shortcut": _arg(a, 1, True)}, True),
    "C2": (M.C2, lambda a: {"shortcut": _arg(a, 1, True)}, True),
    "C3Ghost": (M.C3Ghost, lambda a: {"shortcut": _arg(a, 1, True)}, True),
    "C2PSA": (M.C2PSA, lambda a: {}, True),
    "SPPF": (M.SPPF, lambda a: {"k": _arg(a, 1, 5)}, False),
    "SPP": (M.SPP, lambda a: {"k": tuple(_arg(a, 1, (5, 9, 13)))}, False),
    "GhostConv": (M.GhostConv, lambda a: {"k": _arg(a, 1, 1), "s": _arg(a, 2, 1)}, False),
    "ELAN1": (M.ELAN1, lambda a: {"c3": a[1], "c4": a[2]}, False),
    # its n is its args[3], not the row's repeat
    "RepNCSPELAN4": (M.RepNCSPELAN4, lambda a: {"c3": a[1], "c4": a[2], "n": _arg(a, 3, 1)}, False),
    "ADown": (M.ADown, lambda a: {}, False),
    "AConv": (M.AConv, lambda a: {}, False),
    "SPPELAN": (M.SPPELAN, lambda a: {"c3": a[1], "k": _arg(a, 2, 5)}, False),
    "SCDown": (M.SCDown, lambda a: {"k": _arg(a, 1, 3), "s": _arg(a, 2, 2)}, False),
    "RepVGGDW": (M.RepVGGDW, lambda a: {}, False),
    "CIB": (M.CIB, lambda a: {"shortcut": _arg(a, 1, True), "e": _arg(a, 2, 0.5), "lk": _arg(a, 3, False)}, False),
    "C2fCIB": (M.C2fCIB, lambda a: {"shortcut": _arg(a, 1, False), "lk": _arg(a, 2, False)}, True),
    "PSA": (M.PSA, lambda a: {}, False),
}
DOWNSAMPLE_2 = ("ADown", "AConv")  # rows that halve the map without a stride argument


def make_divisible(x: float, divisor: int = 8) -> int:
    """Round up to the nearest multiple of divisor."""
    return int(math.ceil(x / divisor) * divisor)


def yaml_model_load(path: Union[str, Path]) -> dict:
    """Load a model YAML. A scale letter after the version digits picks a
    scale of the base file: yolov8s-cbam-swin.yaml -> yolov8-cbam-swin.yaml, 's'."""
    path = Path(path)
    models_root = CFG_DIR / "models"
    search_dirs = [path.parent] + sorted(d for d in models_root.iterdir() if d.is_dir())
    names = [(path.name, "")]
    m = re.search(r"(\d+)([nslmx])", path.stem)
    if m:
        names.append((re.sub(r"(\d+)([nslmx])", r"\1", path.stem, count=1) + ".yaml", m.group(2)))
    found, scale = (path, "") if path.exists() else (None, "")
    for name, sc in names:
        if found:
            break
        for d in search_dirs:
            if (d / name).exists():
                found, scale = d / name, sc
                break
    if found is None:
        raise FileNotFoundError(f"model yaml not found: {path}")
    d = yaml.safe_load(found.read_text())
    if scale:
        d["scale"] = scale
    d["yaml_file"] = str(found)
    return d


def parse_model(d: dict) -> Tuple[nn.ModuleList, List[int], Dict[str, Any]]:
    """Build the graph rows (on an RGB input) into modules. Each module carries
    `.i` (its row) and `.f` (where its input comes from); returns (layers,
    save list, meta)."""
    nc = d.get("nc", 80)
    scales = d.get("scales")
    depth = float(d.get("depth_multiple", 1.0))
    width = float(d.get("width_multiple", 1.0))
    max_channels = float(d.get("max_channels", float("inf")))
    scale = d.get("scale") or ""
    if scales:
        scale = scale or next(iter(scales))
        depth, width, max_channels = scales[scale]

    # a YAML-level activation (yolov6's `torch.nn.ReLU()`) covers the Conv rows only, as in the JAX package
    act_str = str(d.get("activation") or "")
    act_override = "relu" if "ReLU" in act_str and "SiLU" not in act_str else None

    chs, factors = [3], [1]  # per produced output: channels (a tuple for CBLinear), spatial downsample
    layers, save = [], set()
    legacy = True  # the Detect cls branch of YOLOv8; a C3k2 or A2C2f row makes it YOLO11's
    for i, (f, n, mname, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        # "nc", and a name of a top-level YAML key (the pose rows' kpt_shape), resolve as the JAX package's
        args = [nc if a == "nc" else d[a] if isinstance(a, str) and a in d else _literal(a) for a in args]
        n = max(round(n * depth), 1) if n > 1 else n

        def in_ch(j):  # j: a row, or counted back from this one (yolov3's -2)
            return chs[j % i + 1] if j != -1 else chs[-1]

        def in_factor(j):
            return factors[j % i + 1] if j != -1 else factors[-1]

        fac = in_factor(f if isinstance(f, int) else f[0])
        c1 = in_ch(f) if isinstance(f, int) else None
        if mname in BASE_MODULES or mname in ("C3k2", "A2C2f"):
            c2 = args[0]
            if c2 != nc:
                c2 = make_divisible(min(c2, max_channels) * width, 8)
            rep = 1  # a row of a module without its own depth repeats the module
            if mname == "C3k2":  # [c2, c3k, e, shortcut]; scales m, l and x force c3k, as the reference
                legacy = False
                cls, kw = M.C3k2, {"n": n, "c3k": True if scale in "mlx" else _arg(args, 1, False),
                                   "e": _arg(args, 2, 0.5), "shortcut": _arg(args, 3, True)}
            elif mname == "A2C2f":  # [c2, a2, area, residual, mlp_ratio]; scales l and x add the gamma residual
                legacy = False
                cls, kw = M.A2C2f, {"n": n, "a2": _arg(args, 1, True),
                                    "area": args[2] if len(args) > 2 and args[2] is not None else 1}
                if scale in "lx" and len(args) <= 3:
                    kw.update(residual=True, mlp_ratio=1.2)
                if len(args) > 3:
                    kw["residual"] = args[3]
                if len(args) > 4:
                    kw["mlp_ratio"] = args[4]
            else:
                cls, kwargs_of, own_depth = BASE_MODULES[mname]
                kw = kwargs_of(args)
                if mname == "Conv" and act_override:
                    kw["act"] = act_override
                if own_depth:
                    kw["n"] = n
                else:
                    rep = n
                fac *= kw.get("s", 1) * (2 if mname in DOWNSAMPLE_2 else 1)
            # repeats run in turn, the first taking c1 (the JAX package's model_<i>_<k> scopes)
            m = cls(c1, c2, **kw) if rep == 1 else nn.Sequential(*(cls(c2 if k else c1, c2, **kw) for k in range(rep)))
            n = 1
        elif mname == "CBAM":
            c2 = c1
            m = M.CBAM(c2, channels=args[0] if args else None)
        elif mname == "SwinBlock":
            c2 = c1  # the YAML dim is advisory; the runtime channels rule
            m = M.SwinBlock(c2, num_heads=_arg(args, 1, 2), window_size=_arg(args, 2, 7))
        elif mname == "Concat":
            c2 = sum(in_ch(j) for j in f)
            m = M.Concat()
        elif mname in ("nn.Upsample", "Upsample"):
            c2 = c1
            scale_f = int(_arg(args, 1, 2))
            fac //= scale_f
            m = M.Upsample(scale_f)
        elif mname == "nn.ConvTranspose2d":  # [c2, k, s, p]: a biased transposed conv, no BN, no activation
            c2 = make_divisible(min(args[0], max_channels) * width, 8)
            k, st = _arg(args, 1, 2), _arg(args, 2, 2)
            fac //= st
            m = M.ConvTranspose2d(c1, c2, k, st, _arg(args, 3, 0))
        elif mname == "nn.MaxPool2d":  # [k, s, p]: torch pads with -inf, as the JAX package
            c2 = c1
            k, st = args[0], _arg(args, 1, args[0])
            fac *= st
            m = nn.MaxPool2d(k, st, _arg(args, 2, 0))
        elif mname == "nn.ZeroPad2d":  # [[left, right, top, bottom]]
            c2 = c1
            m = nn.ZeroPad2d(tuple(args[0]))
        elif mname == "nn.Identity":
            c2 = c1
            m = nn.Identity()
        elif mname == "CBLinear":  # [[c2 of each group], k, s]: the groups are not width-scaled
            c2 = tuple(args[0])
            st = _arg(args, 2, 1)
            fac *= st
            m = M.CBLinear(c1, c2, _arg(args, 1, 1), st)
        elif mname == "CBFuse":  # [[group of each input but the last]]
            c2, fac = in_ch(f[-1]), in_factor(f[-1])
            m = M.CBFuse(args[0])
        elif mname == "Detect":
            c2 = 0
            m = M.Detect(args[0] if args else nc, [in_ch(j) for j in f], [in_factor(j) for j in f], legacy=legacy)
        elif mname == "Segment":  # [nc, nm, npr]: the prototypes' width is scaled, as in the JAX package
            c2 = 0
            npr = make_divisible(min(_arg(args, 2, 256), max_channels) * width, 8)
            m = M.Segment(args[0] if args else nc, [in_ch(j) for j in f], [in_factor(j) for j in f], legacy=legacy,
                          nm=_arg(args, 1, 32), npr=npr)
        elif mname == "Pose":  # [nc, kpt_shape]
            c2 = 0
            m = M.Pose(args[0] if args else nc, [in_ch(j) for j in f], [in_factor(j) for j in f], legacy=legacy,
                       kpt_shape=tuple(_arg(args, 1, (17, 3))))
        elif mname == "v10Detect":
            c2 = 0
            m = M.v10Detect(args[0] if args else nc, [in_ch(j) for j in f], [in_factor(j) for j in f])
        else:
            raise KeyError(f"Unknown module in YAML: {mname!r} (row {i})")
        if n > 1:
            raise KeyError(f"row {i}: repeats of {mname} are not supported by the port")

        def norm(j):
            return j if j == -1 else j % i

        m.i, m.f = i, tuple(norm(j) for j in f) if isinstance(f, (list, tuple)) else norm(f)
        m.type = mname  # the YAML name, which feature maps' file names carry
        layers.append(m)
        save.update(j % i for j in ([f] if isinstance(f, int) else f) if j != -1)
        chs.append(c2)
        factors.append(fac)
    return nn.ModuleList(layers), sorted(save), {"nc": nc, "scale": scale, "depth": depth, "width": width}


def _literal(a):
    """YAML strings such as 'None' become Python values; names stay strings."""
    try:
        return ast.literal_eval(a) if isinstance(a, str) else a
    except (ValueError, SyntaxError):
        return a


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init with the JAX package's schemes: conv and transposed-conv
    kernels uniform with variance 1/(3 fan_in) (fan_in = in channels x kernel
    area), Swin attention projections xavier-uniform, Swin MLP normal with
    variance 1/fan_in, zero biases, unit norms, and the Detect bias priors."""
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight  # (out, in / g, kh, kw), transposed (in, out / g, kh, kw)
            fan_in = w[0].numel() if isinstance(mod, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            bound = math.sqrt(1.0 / fan_in)
            w.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.BatchNorm2d, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, M.SwinBlock):
            for w in (mod.attn.in_proj_weight, mod.attn.out_proj.weight):
                bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
                w.uniform_(-bound, bound, generator=generator)
            for lin in (mod.mlp[0], mod.mlp[2]):
                lin.weight.normal_(0.0, math.sqrt(1.0 / lin.weight.shape[1]), generator=generator)
                lin.bias.zero_()
            mod.attn.in_proj_bias.zero_()
            mod.attn.out_proj.bias.zero_()
    # after the loop: modules() visits a head before its convs, whose bias.zero_() would undo the priors
    for mod in model.modules():
        if isinstance(mod, M.Detect):
            mod.bias_init()


class DetectionModel(nn.Module):
    """A detect graph from its YAML, on `device` (None -> cuda), computing in `dtype`.

    Conv (and transposed conv) and Swin weight matrices are held in
    `param_dtype` (default: `dtype`, which is what inference wants);
    BatchNorm, LayerNorm, the Swin biases and A2C2f's gamma stay fp32.
    Training holds fp32 masters (param_dtype=torch.float32) and computes in
    `dtype`, every weight cast where it is used, as the JAX package does. Activations are NCHW in channels_last memory. forward(x)
    takes (B, 3, H, W) in [0, 1] and returns the Detect head's ((B, 4 + nc,
    A), raw maps), or in training mode the raw maps; a YOLOv10 graph
    (`end2end`) its v10Detect's ((B, 300, 6) detections, {"one2many",
    "one2one"} raw maps), in training the dict; a segmentation graph (task
    "segment") its Segment head's ((B, 4 + nc + nm, A), (raw maps, mask
    coefficients, prototypes)), in training (raw maps, coefficients,
    prototypes); a pose graph (task "pose", `kpt_shape` (nk, nd)) its Pose
    head's ((B, 4 + nc + nk * nd, A), (raw maps, raw keypoints (B, A,
    nk * nd))), in training (raw maps, raw keypoints). The model is built
    in eval mode."""

    def __init__(self, cfg: Union[str, dict] = "yolov8s-cbam-swin.yaml", dtype: torch.dtype = torch.float32,
                 device=None, seed: int = 0, param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = select_device(device)
        self.yaml = dict(cfg) if isinstance(cfg, dict) else yaml_model_load(cfg)
        self.model, self.save, self.meta = parse_model(self.yaml)
        head = self.model[-1]
        self.nc = head.nc
        self.strides = head.strides
        self.end2end = isinstance(head, M.v10Detect)  # NMS-free: the head returns the detections
        self.task = "segment" if isinstance(head, M.Segment) else "pose" if isinstance(head, M.Pose) else "detect"
        self.kpt_shape = head.kpt_shape if self.task == "pose" else None
        self.names = {i: str(i) for i in range(self.nc)}
        self.dtype = dtype
        self.param_dtype = param_dtype or dtype
        init_weights(self, torch.Generator().manual_seed(seed))
        self._cast(self.param_dtype)
        self.to(dev).to(memory_format=torch.channels_last)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def _cast(self, dtype: torch.dtype) -> None:
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
                mod.to(dtype)
            elif isinstance(mod, M.SwinBlock):
                for p in mod.parameters():
                    if p.dim() == 2:
                        p.data = p.data.to(dtype)

    def forward(self, x: torch.Tensor):
        y: Dict[int, Any] = {}
        out = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for m in self.model:
            if m.f != -1:
                out = y[m.f] if isinstance(m.f, int) else [out if j == -1 else y[j] for j in m.f]
            out = m(out)
            if m.i in self.save:
                y[m.i] = out
        return out

    def _outputs(self, x: torch.Tensor):
        """Each layer and its output in order, as forward computes them."""
        y: Dict[int, Any] = {}
        out = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        for m in self.model:
            if m.f != -1:
                out = y[m.f] if isinstance(m.f, int) else [out if j == -1 else y[j] for j in m.f]
            out = m(out)
            if m.i in self.save:
                y[m.i] = out
            yield m, out

    def embed(self, x: torch.Tensor, layers) -> torch.Tensor:
        """(B, sum of C): the output of each of `layers` (indices into the
        graph's rows, negative from the end) mean-pooled over H and W,
        concatenated in row order. The layers after the largest listed one
        do not run. An index that names Detect raises ValueError: its output
        is no feature map. The JAX package's DetectionModel.embed."""
        n = len(self.model)
        wanted = {int(i) % n for i in layers}
        for i in wanted:
            if isinstance(self.model[i], M.Detect):
                raise ValueError(f"embed: layer {i} is {self.model[i].type}, whose output is no feature map; "
                                 f"take a layer before it (0 to {i - 1})")
        pooled = []
        for m, out in self._outputs(x):
            if m.i in wanted:
                pooled.append(out.mean((2, 3)))
                if m.i == max(wanted):
                    break
        return torch.cat(pooled, 1)

    def features(self, x: torch.Tensor, layers=None):
        """[(row, YAML name, (B, C, H, W) output)] of every layer in `layers`
        (default: all) whose output is one rank-4 tensor, for the feature
        maps of predict's visualize: the JAX package's DetectionModel.features
        in the port's layout."""
        n = len(self.model)
        wanted = set(range(n)) if layers is None else {int(i) % n for i in layers}
        return [(m.i, m.type, out) for m, out in self._outputs(x)
                if m.i in wanted and isinstance(out, torch.Tensor) and out.dim() == 4]

    def fuse(self) -> "DetectionModel":
        """Fold every Conv's BatchNorm into its kernel for inference, as the
        JAX package's fuse_variables folds its {conv, bn} pairs: a RepConv's
        two branches keep theirs (Conv.folds)."""
        for mod in self.modules():
            if isinstance(mod, M.Conv) and mod.folds:
                mod.fuse()
        return self

    @property
    def is_fused(self) -> bool:
        return not any(isinstance(m, M.Conv) and m.folds and m.bn is not None for m in self.modules())

    def predict_augment(self, x: torch.Tensor) -> torch.Tensor:
        """Three-scale and left-right flip test-time augmentation, as the JAX
        package's DetectionModel.predict_augment: x (B, 3, H, W) in [0, 1]
        runs at scales 1, 0.83 (flipped along the width) and 0.67. A scaled
        copy is resized as jax.image.resize(method="linear") resizes, which
        filters as it shrinks (`tta_resize`), then padded at the bottom and
        right with 0.447 to a multiple of the largest stride. Each run's boxes
        go back to the input's scale (xywh / scale; the flipped run's x centre
        becomes W - x), the first run drops the anchors of its coarsest level
        (large objects) and the last those of its finest (small objects), and
        the three concatenate along the anchors: (B, 4 + nc, A') in fp32. A
        segmentation or pose model returns its plain forward's prediction,
        as in the JAX package."""
        if self.task != "detect":
            return self(x)[0].float()
        w0 = x.shape[3]
        outs = []
        for (si, flip), xi in zip(TTA_RUNS, tta_inputs(x, int(max(self.strides)))):
            yi = self(xi)[0].float()
            box = yi[:, :4] / si
            if flip:
                box = torch.cat([w0 - box[:, :1], box[:, 1:]], 1)
            outs.append(torch.cat([box, yi[:, 4:]], 1))
        nl = len(self.strides)
        g = sum(4 ** k for k in range(nl))
        outs[0] = outs[0][..., :-(outs[0].shape[-1] // g)]
        outs[-1] = outs[-1][..., (outs[-1].shape[-1] // g) * 4 ** (nl - 1):]
        return torch.cat(outs, -1)


TTA_RUNS = ((1.0, False), (0.83, True), (0.67, False))  # (scale, flip along the width) of predict_augment


def tta_inputs(x: torch.Tensor, gs: int):
    """The inputs of predict_augment's runs (TTA_RUNS): x flipped along the
    width where the run flips, resized by its scale (tta_resize) and padded
    at the bottom and right with 0.447 to a multiple of the stride gs."""
    h0, w0 = x.shape[2], x.shape[3]
    for si, flip in TTA_RUNS:
        xi = x.flip(-1) if flip else x
        if si != 1.0:
            nh, nw = int(h0 * si), int(w0 * si)
            ph, pw = math.ceil(h0 * si / gs) * gs - nh, math.ceil(w0 * si / gs) * gs - nw
            xi = F.pad(tta_resize(xi, nh, nw), (0, pw, 0, ph), value=0.447)
        yield xi


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) fp32 weights of one axis of jax.image.resize with the
    linear (triangle) kernel and antialias=True: the kernel widened by
    1 / scale when it shrinks, each output's weights normalised to sum 1,
    computed in fp32 as JAX computes them."""
    inv = 1.0 / torch.tensor(n_out / n_in, dtype=torch.float32)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / torch.clamp(inv, min=1.0)
    w = torch.clamp(1.0 - dist.abs(), min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def tta_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """x (B, C, H, W) resized to (h, w) as jax.image.resize(method="linear")
    resizes the NHWC twin: a product with each axis's weights, cast to x's
    dtype as JAX casts them, the width first (two matrix products, never the
    (H, W, h, w) outer product of the weights)."""
    wh = resize_weights(x.shape[2], h, x.device).to(x.dtype)
    ww = resize_weights(x.shape[3], w, x.device).to(x.dtype)
    return torch.matmul(wh.t(), torch.matmul(x, ww))


class EnsembleModel(nn.Module):
    """Detection models served as one, as the JAX package's EnsembleModel:
    every member runs on the same input, their (B, 4 + nc, A) predictions
    concatenate along the anchors, and the predictor's one NMS keeps the
    best boxes of all. Inference only: the members must share nc and end in
    Detect (an NMS-free YOLOv10 member is refused, as in the JAX package),
    and the input is padded to the coarsest member stride. A segmentation
    or pose member is refused, as in the JAX package."""

    def __init__(self, models):
        super().__init__()
        if not models:
            raise ValueError("an ensemble needs at least one model")
        ncs = sorted({m.nc for m in models})
        if len(ncs) != 1:
            raise ValueError(f"ensemble members disagree on nc: {ncs}")
        if any(m.end2end or m.task != "detect" for m in models):
            raise ValueError("only plain detect heads can be NMS-ensembled: a YOLOv10 (end2end), a "
                             "segmentation member or a pose member is not")
        self.members = nn.ModuleList(models)
        m0 = models[0]
        self.nc, self.names, self.dtype = m0.nc, m0.names, m0.dtype
        self.end2end = False
        self.task = "detect"
        self.strides = tuple(max(s) for s in zip(*(tuple(m.strides) for m in models)))
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.members[0].device

    @property
    def is_fused(self) -> bool:
        return all(m.is_fused for m in self.members)

    def fuse(self) -> "EnsembleModel":
        for m in self.members:
            m.fuse()
        return self

    def forward(self, x: torch.Tensor):
        if self.training:
            raise NotImplementedError("an ensemble is not trained: train one member")
        return torch.cat([m(x)[0] for m in self.members], -1), None
