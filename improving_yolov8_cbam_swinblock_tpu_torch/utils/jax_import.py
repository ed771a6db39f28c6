"""Weight bridge between the JAX package's variables and this port's state_dict.

`state_dict_from_jax` takes the flax `{"params", "batch_stats"}` tree as
nested mappings of numpy arrays and names each leaf the way the
reference's torch state names it (the inverse of the JAX package's torch
importer), with layout transforms:

  * conv kernels HWIO -> OIHW;
  * transposed-conv kernels (kh, kw, in, out) -> (in, out, kh, kw), flipped
    in space: flax's ConvTranspose does not flip its kernel, torch's does;
  * Dense kernels (in, out) -> Linear weights (out, in) (Classify's `linear`);
  * the SwinBlock's and RT-DETR's packed in-projections (C, 3C) -> in_proj_weight (3C, C);
  * RT-DETR's scopes that flax flattens with underscores (`input_proj_0`,
    `decoder_layers_0`, `enc_output_0`, `dec_bbox_head_0`, an MLP's
    `layers_0`) -> the reference's dotted names, AIFI's `enc` scope dropped
    (its `fc1` stays `fc1`), and the head's embedding table
    (`denoising_class_embed`, a leaf of the head's own scope) ->
    `denoising_class_embed.weight`;
  * YOLO-World's scopes (`projections_0`, ImagePoolingAttn's `query_ln`
    and `query_fc`, which the reference holds as `query.0` and `query.1`)
    and leaves (`scale_p` -> `scale`; a contrastive head's `bias` and
    `logit_scale` as they are);
  * BatchNorm scale/bias and mean/var -> weight/bias and
    running_mean/running_var (plus num_batches_tracked, which flax has not).

A tree that holds a BN-folded `fused` collection is refused there;
`fused_state_from_jax` maps such a tree (the JAX package's fuse_variables:
folded kernels under `params`, their biases under `fused`, the unused BN
leaves beside them, and a RepConv's two branches unfolded, with their BN
statistics) onto a fused port model without folding again.
`jax_variables_from_state` is the way back: a port model's state as the
JAX package's variables, which `.ckpt` files carry. `overlay_state` copies
a source state onto a model by name and shape, as the JAX package's
warm start and `YOLO.load` overlay their trees.

`quant_state_from_jax` carries the JAX package's int8 `quant` collection
into the buffers that ops/quant.py's load_quant_state sets.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..nn import modules as M
from ..nn import modules_world as W
from ..nn import transformer as T
from . import serialization


# flax scopes named otherwise in the reference's state: CBAM's channel MLP,
# a GhostBottleneck's branches, RepNCSPELAN4's two (RepCSP, Conv) branches
# and a RepConv's two (conv, bn) branches, which the JAX package holds
# without a scope of their own, and ImagePoolingAttn's (LayerNorm, Linear)
# pairs, which it holds as query_ln and query_fc
SCOPE_NAMES = {"fc1": "shared_MLP.0", "fc2": "shared_MLP.2",
               "gc1": "conv.0", "dwmid": "conv.1", "gc2": "conv.2", "sc_dw": "shortcut.0", "sc_pw": "shortcut.1",
               "cv2_csp": "cv2.0", "cv2_conv": "cv2.1", "cv3_csp": "cv3.0", "cv3_conv": "cv3.1",
               "conv1_conv": "conv1.conv", "conv1_bn": "conv1.bn", "conv2_conv": "conv2.conv", "conv2_bn": "conv2.bn",
               **{f"{n}_{part}": f"{n}.{i}" for n in ("query", "key", "value") for i, part in enumerate(("ln", "fc"))}}
# flax scopes with no module of their own in the port: the JAX package's
# DWConv wraps a Conv in `dw`, its C3k a C3 in `c3`, its
# nn.ConvTranspose2d row a flax ConvTranspose in `conv_transpose`, and its
# Segment, Pose and OBB heads the detect branches in `detect` (the
# reference names them at the head's own level)
DROPPED_SCOPES = ("dw", "c3", "conv_transpose", "detect", "enc")
# RT-DETR's and ImagePoolingAttn's numbered scopes, which flax joins with an underscore; the decoder's layers have no
# scope of their own
NUMBERED_SCOPES = re.compile(r"(input_proj|enc_output|dec_score_head|dec_bbox_head|layers|projections)_(\d+)")
DECODER_LAYERS = re.compile(r"decoder_layers_(\d+)")
# a leaf that is an RT-DETR head's own parameter (an embedding table), not a module's
EMBEDDINGS = ("denoising_class_embed",)
# YOLO-World's parameters of a module's own (MaxSigmoidAttnBlock's and ImagePoolingAttn's scale, a contrastive
# head's bias and logit scale): the flax leaf -> the reference's name
WORLD_LEAVES = {"scale_p": "scale", "logit_scale": "logit_scale"}
# the flax scopes whose kernel is a transposed conv's: the nn.ConvTranspose2d
# row's, and Proto's `upsample`
TRANSPOSED_SCOPES = ("conv_transpose", "upsample")


def _module_tokens(mods: Tuple[str, ...]) -> list:
    """flax module scopes -> the port's module path tokens."""
    toks = []
    for i, m in enumerate(mods):
        if m in DROPPED_SCOPES:
            continue
        if i and mods[i - 1] == "enc":  # AIFI's encoder layer: ma, fc1, fc2, norm1, norm2 as they are
            toks.append(m)
        elif NUMBERED_SCOPES.fullmatch(m):
            name, idx = m.rsplit("_", 1)
            toks.append(f"{name}.{idx}")
        elif DECODER_LAYERS.fullmatch(m):
            toks.append("decoder.layers." + m.rsplit("_", 1)[1])
        elif m in SCOPE_NAMES:
            toks.append(SCOPE_NAMES[m])
        elif m.startswith("model_"):  # a row, or a repeat of it (model_10_3)
            toks.append("model." + ".".join(m.split("_")[1:]))
        elif m.startswith("mlp_fc"):  # Swin MLP: fc1 -> mlp.0, fc2 -> mlp.2
            toks.append("mlp.0" if m.endswith("1") else "mlp.2")
        elif m.startswith("one2one_"):  # v10Detect's one-to-one twin: one2one_cv3_0_1_0 -> one2one_cv3.0.1.0
            toks.append("one2one_" + ".".join(m[len("one2one_"):].split("_")))
        elif re.fullmatch(r"(layer\d*|shortcut)_\d+", m):
            # ResNetLayer's blocks (layer_0), a ResNet block's projection (shortcut_0), TorchVision's BasicBlocks
            # (layer1_0): the reference's layer.0 and shortcut.0, and the JAX package's scopes with dots
            toks.append(m.replace("_", "."))
        elif m.startswith(("cv1_", "cv2_", "cv3_", "cv4_", "m_", "ffn_", "mlp_")):
            # Detect per-level stacks (Segment's, Pose's and OBB's cv4_0_0 too), CIB's cv1_0 to cv1_4, bottlenecks
            # (m_0, RepCSP's m_0_cv1, A2C2f's m_0_1), PSA and ABlock MLPs
            toks.append(".".join(m.split("_")))
        else:
            toks.append(m)
    return toks


def _torch_name(path: Tuple[str, ...], collection: str) -> Tuple[str, str]:
    """(flax path) -> (torch name, transform tag)."""
    *mods, leaf = path
    toks = _module_tokens(mods)
    if collection == "batch_stats":
        return ".".join(toks) + "." + {"mean": "running_mean", "var": "running_var"}[leaf], "none"
    if leaf in EMBEDDINGS:
        return ".".join(toks + [leaf, "weight"]), "none"
    if toks and toks[-1] == "in_proj":  # torch MultiheadAttention packs qkv at the attention level
        prefix = ".".join(toks[:-1])
        return (f"{prefix}.in_proj_weight", "linear_t") if leaf == "kernel" else (f"{prefix}.in_proj_bias", "none")
    base = ".".join(toks)
    if leaf == "kernel":
        return f"{base}.weight", "kernel_t" if mods[-1] in TRANSPOSED_SCOPES else "kernel"
    if leaf == "scale":
        return f"{base}.weight", "none"
    if leaf in ("bias", "gamma"):  # gamma: A2C2f's residual scale
        return ".".join(toks + [leaf]), "none"
    if leaf in WORLD_LEAVES:
        return ".".join(toks + [WORLD_LEAVES[leaf]]), "none"
    raise KeyError(f"unmapped flax leaf {'/'.join(path)} ({collection})")


def _transform(arr: np.ndarray, tag: str) -> np.ndarray:
    if tag == "kernel_t":
        return arr[::-1, ::-1].transpose(2, 3, 0, 1)  # (kh, kw, in, out) flipped -> (in, out, kh, kw)
    if tag in ("kernel", "linear_t") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if tag in ("kernel", "linear_t") and arr.ndim == 2:
        return arr.T
    return arr


def _numpy(val) -> np.ndarray:
    """A leaf as numpy: a torch tensor (bfloat16 leaves of a checkpoint) in fp32."""
    if isinstance(val, torch.Tensor):
        return val.detach().float().cpu().numpy()
    return np.asarray(val)


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), _numpy(val)


def _tensor(arr: np.ndarray, tag: str = "none") -> torch.Tensor:
    return torch.from_numpy(np.array(_transform(arr, tag), dtype=np.float32, order="C"))


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> a state_dict that the port's
    DetectionModel loads with strict=True. Tensors are fp32 on the CPU;
    load_state_dict casts them to each parameter's dtype and device."""
    if "fused" in variables:
        raise ValueError("variables hold a BN-folded 'fused' collection: load the unfused "
                         "variables, then fuse() the port model")
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection, {})):
            name, tag = _torch_name(path, collection)
            if name in state:
                raise KeyError(f"two flax leaves map to {name}")
            state[name] = _tensor(arr, tag)
            if name.endswith(".running_mean"):
                state[name[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return state


def fused_state_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """BN-folded JAX variables -> the state of a fused port model (each Conv
    a conv.weight and a conv.bias, no BatchNorm): the folded kernels of
    `params` and the biases of `fused` map straight across, the BN leaves of
    every folded Conv and the batch statistics are dropped."""
    fused = variables.get("fused") or {}
    if not fused:
        raise ValueError("variables hold no 'fused' collection: use state_dict_from_jax")
    folded = {path[:-1] for path, _ in _leaves(fused)}  # the scopes of the folded Conv blocks

    def unfolded(path):  # a leaf of no folded Conv's BatchNorm (RepConv's branches keep theirs)
        return not (len(path) > 2 and path[-2] == "bn" and path[:-2] in folded)

    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, arr in _leaves(variables.get(collection) or {}):
            if unfolded(path):
                name, tag = _torch_name(path, collection)
                state[name] = _tensor(arr, tag)
                if name.endswith(".running_mean"):
                    state[name[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    for path, arr in _leaves(fused):
        if path[-1] != "bias":
            raise KeyError(f"unmapped leaf of the fused collection: {'/'.join(path)}")
        state[".".join(_module_tokens(path[:-1]) + ["conv", "bias"])] = _tensor(arr)
    return state


def _flax_scopes(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """Each module path of a port model -> the flax scope of its JAX twin:
    numbered containers (and a RepBottleneck, and a RepConv's two Convs)
    join their indices or names to their name (cv2.0.1 -> cv2_0_1, m.0 ->
    m_0, model.7 -> model_7, a repeated row's model.10.3 -> model_10_3,
    m.0.cv1 of a RepCSP -> m_0_cv1, conv1.bn -> conv1_bn), the children
    renamed in SCOPE_NAMES and the Swin MLP's 0 and 2 (mlp_fc1, mlp_fc2)
    take their JAX names, a DWConv and a C3k open the `dw` and `c3`
    scopes the JAX package wraps them in, a Segment, Pose or OBB head's
    detect branches (cv2, cv3) its `detect` scope, AIFI's layer its `enc`
    scope, and RT-DETR's decoder no scope (its layers are decoder_layers_0)."""
    scopes: Dict[str, Tuple[str, ...]] = {"": ()}
    inverse = {v: k for k, v in SCOPE_NAMES.items()}

    def renamed(mod: nn.Module, name: str, child: nn.Module):
        """{index: flax scope} for a container whose children the JAX package names otherwise."""
        if isinstance(mod, M.SwinBlock) and name == "mlp":
            return {"0": "mlp_fc1", "2": "mlp_fc2"}
        if isinstance(child, nn.Sequential) and isinstance(mod, (M.ChannelAttention, M.GhostBottleneck,
                                                                  M.RepNCSPELAN4, W.ImagePoolingAttn)):
            return {idx: inverse[f"{name}.{idx}"] for idx, _ in child.named_children() if f"{name}.{idx}" in inverse}
        return None

    def enter(child: nn.Module, cpath: str, cscope: Tuple[str, ...]):
        cscope += (("dw",) if isinstance(child, M.DWConv) else ()) + (("c3",) if isinstance(child, M.C3k) else ())
        scopes[cpath] = cscope
        walk(child, cpath, cscope, None)

    def walk(mod: nn.Module, path: str, scope: Tuple[str, ...], group):
        if isinstance(mod, T.AIFI):
            scope += ("enc",)
        for name, child in mod.named_children():
            cpath = f"{path}.{name}" if path else name
            token = f"{group}_{name}" if group else name
            if isinstance(mod, (M.Segment, M.Pose, M.OBB)) and name in ("cv2", "cv3"):
                walk(child, cpath, scope + ("detect",), token)
                continue
            rename = renamed(mod, name, child)
            if rename is not None:
                for idx, sub in child.named_children():
                    if idx in rename:
                        enter(sub, f"{cpath}.{idx}", scope + (rename[idx],))
            elif (type(child) in (nn.ModuleList, nn.Sequential, M.RepBottleneck, T.DeformableTransformerDecoder)
                  or isinstance(mod, M.RepConv)):
                walk(child, cpath, scope, token)
            else:
                enter(child, cpath, scope + (token,))

    walk(model, "", (), None)
    return scopes


def _flax_leaf(mod: nn.Module, parent: nn.Module, attr: str):
    """(collection, sub-scope within the module's scope, leaf name) of a port
    tensor; the bias of a fused Conv's conv goes to `fused` under the Conv's
    scope; an embedding table's leaf is its module's scope itself (leaf None)."""
    if isinstance(mod, nn.Conv2d):
        if attr == "bias" and isinstance(parent, M.Conv):
            return "fused", (), "bias"
        return "params", (), {"weight": "kernel", "bias": "bias"}[attr]
    if isinstance(mod, nn.ConvTranspose2d):  # Proto's upsample is a flax ConvTranspose of its own name
        sub = () if isinstance(parent, M.Proto) else ("conv_transpose",)
        return "params", sub, {"weight": "kernel", "bias": "bias"}[attr]
    if isinstance(mod, M.A2C2f) and attr == "gamma":
        return "params", (), "gamma"
    if isinstance(mod, nn.BatchNorm2d):
        return {"weight": ("params", (), "scale"), "bias": ("params", (), "bias"),
                "running_mean": ("batch_stats", (), "mean"), "running_var": ("batch_stats", (), "var")}[attr]
    if isinstance(mod, nn.LayerNorm):
        return "params", (), {"weight": "scale", "bias": "bias"}[attr]
    if isinstance(mod, nn.Linear):
        return "params", (), {"weight": "kernel", "bias": "bias"}[attr]
    if isinstance(mod, (nn.MultiheadAttention, T.MHA)):
        return "params", ("in_proj",), {"in_proj_weight": "kernel", "in_proj_bias": "bias"}[attr]
    if isinstance(mod, nn.Embedding):  # an RT-DETR head's table: a leaf of the head's scope, named as the module
        return "params", (), None
    if isinstance(mod, (W.MaxSigmoidAttnBlock, W.ImagePoolingAttn, W.ContrastiveHead, W.BNContrastiveHead)):
        return "params", (), {"bias": "bias", "scale": "scale_p", "logit_scale": "logit_scale"}[attr]
    raise KeyError(f"no JAX twin for {type(mod).__name__}.{attr}")


def jax_variables_from_state(model: nn.Module) -> Dict[str, dict]:
    """The port model's weights as the JAX package's variables, fp32 numpy
    leaves in its layouts: {"params", "batch_stats"}, and for a fused model
    {"params", "batch_stats": {}, "fused"} (folded kernels, their biases).
    Every name is checked against the forward bridge (`_torch_name`)."""
    if any(getattr(m, "w_int8", None) is not None or getattr(m, "qkv_w_int8", None) is not None
           for m in model.modules()):
        raise ValueError("a quantized model has no JAX variables here: write the float model")
    scopes = _flax_scopes(model)
    out: Dict[str, dict] = {"params": {}, "batch_stats": {}}
    for name, t in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        mpath, attr = name.rsplit(".", 1)
        mod = model.get_submodule(mpath)
        ppath = mpath.rsplit(".", 1)[0] if "." in mpath else ""
        coll, sub, leaf = _flax_leaf(mod, model.get_submodule(ppath), attr)
        if coll == "fused":
            path = scopes[ppath] + ("bias",)
            tag = "none"
        else:
            path = scopes[mpath] + sub + ((leaf,) if leaf else ())
            back, tag = _torch_name(path, coll)
            if back != name:
                raise KeyError(f"{name} maps to {'/'.join(path)}, which maps back to {back}")
        arr = t.detach().float().cpu().numpy()
        if tag == "kernel_t":
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        elif tag in ("kernel", "linear_t"):
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = out.setdefault(coll, {})
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(arr, dtype=np.float32, order="C")  # a 0-d leaf stays 0-d (a logit scale)
    return out


def overlay_state(targets: Iterable[Tuple[str, torch.Tensor]], src: Mapping[str, torch.Tensor]) -> Dict[str, int]:
    """Copy src[name] into each target tensor whose shape it matches (cast
    to the target's dtype and device); a missing name or another shape keeps
    the target (another nc keeps the fresh Detect class convs). Returns the
    leaves matched and skipped."""
    matched = skipped = 0
    with torch.no_grad():
        for name, t in targets:
            s = src.get(name)
            if s is not None and tuple(s.shape) == tuple(t.shape):
                t.copy_(s)
                matched += 1
            else:
                skipped += 1
    return {"matched": matched, "skipped": skipped}


def read_checkpoint(path) -> dict:
    """The payload of a `.ckpt` / `.msgpack` file: the JAX package's YOLO.save
    (model_yaml, nc, names, ema_params, ema_stats, fused, args), its
    trainer's checkpoints (the same plus step, params, batch_stats, mom_buf,
    var_buf, ema_updates, epoch, best_fitness) or the port's YOLO.save."""
    return serialization.loads(Path(path).read_bytes())


def ema_state(payload: Mapping) -> Dict[str, torch.Tensor]:
    """A checkpoint's EMA weights (ema_params, ema_stats) as an unfused port
    state, what the warm start and YOLO.load overlay. A BN-folded checkpoint
    (a non-empty `fused` collection) raises: its folded kernels beside
    BatchNorms would apply the fold twice, or lose the folded biases."""
    if payload.get("fused"):
        raise ValueError("a BN-folded checkpoint cannot be overlaid onto an unfused model: "
                         "load it with YOLO(path), or use the unfused checkpoint")
    return state_dict_from_jax({"params": payload["ema_params"], "batch_stats": payload.get("ema_stats") or {}})


def quant_state_from_jax(quant: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's `quant` collection (numpy leaves) -> {"<module>.<buffer>":
    tensor} for ops.quant.load_quant_state. A Conv's w_int8 goes HWIO ->
    OIHW and a SwinBlock's <k>_w_int8 (in, out) -> (out, in); int8 stays int8,
    scales are fp32."""
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(quant):
        *mods, leaf = path
        if leaf.endswith("w_int8"):
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            t = torch.from_numpy(np.array(arr, dtype=np.int8, order="C"))
        else:
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
        state[".".join(_module_tokens(tuple(mods)) + [leaf])] = t
    return state
