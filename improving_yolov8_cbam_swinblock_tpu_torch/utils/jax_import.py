"""Weight bridge: the JAX package's variables -> this port's state_dict.

Takes the flax `{"params", "batch_stats"}` tree as nested mappings of numpy
arrays and names each leaf the way the reference's torch state names it
(the inverse of the JAX package's torch importer), with layout transforms:

  * conv kernels HWIO -> OIHW;
  * Dense kernels (in, out) -> Linear weights (out, in);
  * the SwinBlock packed in-projection (C, 3C) -> in_proj_weight (3C, C);
  * BatchNorm scale/bias and mean/var -> weight/bias and
    running_mean/running_var (plus num_batches_tracked, which flax has not).

A tree that already holds a BN-folded `fused` collection is refused: load
the unfused variables and call the port's `fuse()` instead.

`quant_state_from_jax` carries the JAX package's int8 `quant` collection
into the buffers that ops/quant.py's load_quant_state sets.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _module_tokens(mods: Tuple[str, ...]) -> list:
    """flax module scopes -> the port's module path tokens. The JAX package's
    DWConv wraps a Conv in a `dw` scope and its C3k a C3 in a `c3` scope;
    the port's DWConv is a Conv and its C3k a C3, so both scopes drop."""
    toks = []
    for m in mods:
        if m in ("dw", "c3"):
            continue
        if m.startswith("model_"):
            toks.append("model." + ".".join(m.split("_")[1:]))
        elif m.startswith(("cv2_", "cv3_", "m_", "ffn_")):  # Detect per-level stacks, C2f bottlenecks, PSA FFN
            toks.append(".".join(m.split("_")))
        elif m.startswith("mlp_fc"):  # Swin MLP: fc1 -> mlp.0, fc2 -> mlp.2
            toks.append("mlp.0" if m.endswith("1") else "mlp.2")
        elif m == "fc1":  # CBAM channel-attention MLP
            toks.append("shared_MLP.0")
        elif m == "fc2":
            toks.append("shared_MLP.2")
        else:
            toks.append(m)
    return toks


def _torch_name(path: Tuple[str, ...], collection: str) -> Tuple[str, str]:
    """(flax path) -> (torch name, transform tag)."""
    *mods, leaf = path
    toks = _module_tokens(mods)
    if collection == "batch_stats":
        return ".".join(toks) + "." + {"mean": "running_mean", "var": "running_var"}[leaf], "none"
    if toks[-1] == "in_proj":  # torch MultiheadAttention packs qkv at the attention level
        prefix = ".".join(toks[:-1])
        return (f"{prefix}.in_proj_weight", "linear_t") if leaf == "kernel" else (f"{prefix}.in_proj_bias", "none")
    base = ".".join(toks)
    if leaf == "kernel":
        return f"{base}.weight", "kernel"
    if leaf == "scale":
        return f"{base}.weight", "none"
    if leaf == "bias":
        return f"{base}.bias", "none"
    raise KeyError(f"unmapped flax leaf {'/'.join(path)} ({collection})")


def _transform(arr: np.ndarray, tag: str) -> np.ndarray:
    if tag in ("kernel", "linear_t") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if tag in ("kernel", "linear_t") and arr.ndim == 2:
        return arr.T
    return arr


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


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
            state[name] = torch.from_numpy(np.array(_transform(arr, tag), dtype=np.float32, order="C"))
            if name.endswith(".running_mean"):
                state[name[: -len("running_mean")] + "num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return state


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
