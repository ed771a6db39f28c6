"""Offline text encoders for the open-vocabulary World graphs (the port's
copy of the JAX package's utils/text_model.py).

The reference encodes prompts with CLIP and downloads its weights; nothing
here downloads. `encode_texts` gives L2-normalised float32 (n, dim)
embeddings from one of three sources:

1. a CLIP weight archive (an npz holding `token_embedding`, the layout of
   the JAX package's tools/export_clip_npz.py): the BPE tokenizer
   (utils/clip_bpe.py) and `CLIPTextTower`, the causal pre-LN text
   transformer in PyTorch (fp32, on the card unless the caller asks for
   the CPU);
2. a per-prompt vector archive (an npz of {prompt: vector});
3. by default, the deterministic hash projection: each prompt's sha256
   seeds numpy's default_rng, which draws a standard normal vector: a
   stable text space (distinct prompts near orthogonal) without semantics,
   numpy in both packages, so equal bit for bit.

The `clip_npz` setting (utils/settings.py) names an archive to use where
the caller passes none.
"""

from __future__ import annotations

import hashlib
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .device import select_device

EMBED_DIM = 512


class CLIPTextTower:
    """CLIP's text encoder over an imported weight dict, in fp32 on `device`
    (None: the card, utils/device.py's rule).

    Weight keys (float32 numpy, torch layout): token_embedding (V, D),
    position_embedding (P, D), L{i}.ln1.{w,b}, L{i}.attn.{q,k,v,out}.{w,b}
    (Linear (out, in) weights), L{i}.ln2.{w,b}, L{i}.mlp.fc1/fc2.{w,b},
    ln_final.{w,b}, text_projection (proj, D), and optionally num_heads.
    Pooled at the first end-of-text token, then projected."""

    def __init__(self, params: Dict[str, np.ndarray], eot_id: int, device=None):
        self.device = select_device(device)
        self.p = {k: torch.as_tensor(np.asarray(v, np.float32), device=self.device) for k, v in params.items()}
        self.eot_id = int(eot_id)
        self.layers = 0
        while f"L{self.layers}.ln1.w" in self.p:
            self.layers += 1
        self.width = self.p["token_embedding"].shape[1]
        self.heads = int(params["num_heads"]) if "num_heads" in params else max(1, self.width // 64)

    def _ln(self, x, w, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.p[w] + self.p[b]

    def _lin(self, x, name):
        return x @ self.p[f"{name}.w"].T + self.p[f"{name}.b"]

    @torch.no_grad()
    def __call__(self, token_ids: np.ndarray) -> np.ndarray:
        p = self.p
        ids = torch.as_tensor(np.asarray(token_ids), dtype=torch.long, device=self.device)
        b, t = ids.shape
        x = p["token_embedding"][ids] + p["position_embedding"][:t]
        causal = torch.ones(t, t, dtype=torch.bool, device=self.device).tril()
        hd = self.width // self.heads

        def heads(y):
            return y.reshape(b, t, self.heads, hd).transpose(1, 2)

        for i in range(self.layers):
            h = self._ln(x, f"L{i}.ln1.w", f"L{i}.ln1.b")
            q, k, v = (heads(self._lin(h, f"L{i}.attn.{n}")) for n in ("q", "k", "v"))
            a = (q @ k.transpose(-1, -2)) * hd ** -0.5
            a = torch.where(causal, a, torch.full_like(a, -torch.inf))
            a = torch.exp(a - a.amax(-1, keepdim=True))
            a = a / a.sum(-1, keepdim=True)
            x = x + self._lin((a @ v).transpose(1, 2).reshape(b, t, self.width), f"L{i}.attn.out")
            h = self._lin(self._ln(x, f"L{i}.ln2.w", f"L{i}.ln2.b"), f"L{i}.mlp.fc1")
            x = x + self._lin(h * torch.sigmoid(1.702 * h), f"L{i}.mlp.fc2")
        x = self._ln(x, "ln_final.w", "ln_final.b")
        eot = (ids == self.eot_id).int().argmax(1)
        return (x[torch.arange(b, device=self.device), eot] @ p["text_projection"].T).cpu().numpy()


def _tower_from_archive(arc, device) -> tuple:
    """(tower, tokenizer) of a CLIP weight archive, its vocabulary and merges held in it."""
    from .clip_bpe import CLIPBPETokenizer

    params = {k: arc[k] for k in arc.files if k not in ("vocab_json", "merges_txt", "eot_id")}
    with tempfile.TemporaryDirectory() as d:
        vocab, merges = f"{d}/vocab.json", f"{d}/merges.txt"
        with open(vocab, "w", encoding="utf-8") as f:
            f.write(str(arc["vocab_json"]))
        with open(merges, "w", encoding="utf-8") as f:
            f.write(str(arc["merges_txt"]))
        tok = CLIPBPETokenizer(vocab, merges, context_length=int(params["position_embedding"].shape[0]))
    return CLIPTextTower(params, eot_id=int(arc["eot_id"]), device=device), tok


def hash_embedding(text: str, dim: int = EMBED_DIM) -> np.ndarray:
    """The hash projection of one prompt, before normalisation: a standard
    normal draw of numpy's default_rng seeded by the first 8 bytes of the
    prompt's sha256, little-endian."""
    seed = int.from_bytes(hashlib.sha256(str(text).encode()).digest()[:8], "little")
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def encode_texts(texts: Sequence[str], dim: int = EMBED_DIM, npz_path: Optional[str] = None,
                 device=None) -> np.ndarray:
    """L2-normalised float32 (n, dim) embeddings of the prompts: from the
    archive `npz_path` (a CLIP weight archive runs the tokenizer and the
    tower on `device`, None the card; a vector archive is looked up), else
    from the `clip_npz` setting's archive, else the hash projection."""
    if not npz_path:
        from .settings import SETTINGS

        npz_path = str(SETTINGS.get("clip_npz") or "") or None
    if npz_path:
        with np.load(npz_path) as arc:
            if "token_embedding" in arc.files:
                tower, tok = _tower_from_archive(arc, device)
                out = tower(tok(list(texts)))
            else:
                out = np.stack([arc[t] for t in texts]).astype(np.float32)
    else:
        out = np.stack([hash_embedding(t, dim) for t in texts])
    return out / np.maximum(np.linalg.norm(out, axis=-1, keepdims=True), 1e-12)


def hf_state_to_params(state: Dict[str, np.ndarray], num_heads: int) -> Dict[str, np.ndarray]:
    """A HF `CLIPTextModelWithProjection` state dict (numpy values) in the
    CLIPTextTower layout."""
    g = lambda k: np.asarray(state[k], np.float32)
    p: Dict[str, np.ndarray] = {
        "token_embedding": g("text_model.embeddings.token_embedding.weight"),
        "position_embedding": g("text_model.embeddings.position_embedding.weight"),
        "ln_final.w": g("text_model.final_layer_norm.weight"),
        "ln_final.b": g("text_model.final_layer_norm.bias"),
        "text_projection": g("text_projection.weight"),
        "num_heads": np.asarray(num_heads),
    }
    i = 0
    while f"text_model.encoder.layers.{i}.layer_norm1.weight" in state:
        pre = f"text_model.encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            p[f"L{i}.{ours}.w"] = g(f"{pre}.{theirs}.weight")
            p[f"L{i}.{ours}.b"] = g(f"{pre}.{theirs}.bias")
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            p[f"L{i}.attn.{ours}.w"] = g(f"{pre}.self_attn.{theirs}.weight")
            p[f"L{i}.attn.{ours}.b"] = g(f"{pre}.self_attn.{theirs}.bias")
        for fc in ("fc1", "fc2"):
            p[f"L{i}.mlp.{fc}.w"] = g(f"{pre}.mlp.{fc}.weight")
            p[f"L{i}.mlp.{fc}.b"] = g(f"{pre}.mlp.{fc}.bias")
        i += 1
    return p
