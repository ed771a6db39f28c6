"""The port's offline text space (utils/text_model.py, utils/clip_bpe.py) vs the JAX package's.

The hash projection bit for bit on prompts with spaces, punctuation,
digits, case and non-ASCII letters; the BPE tokenizer against JAX's on a
vocabulary built in the test (the byte alphabet, its word-final forms and
a few merges, HF's layout); the CLIP text tower in PyTorch against JAX's
CLIPTextTower on seeded weights (2 layers of width 32, 4 heads, causal
attention, pooled at the first end-of-text token), within TOWER_TOL; a
weight archive and a per-prompt vector archive through encode_texts, and
the `clip_npz` setting routing encode_texts to an archive;
hf_state_to_params against JAX's on a state dict of HF's names. The port's
modules import no `regex` until a tokenizer is built (the card's machine
has none), checked in a subprocess.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from improving_yolov8_cbam_swinblock_tpu.utils import clip_bpe as JB
from improving_yolov8_cbam_swinblock_tpu.utils import text_model as JT
from improving_yolov8_cbam_swinblock_tpu_torch.utils import clip_bpe as PB
from improving_yolov8_cbam_swinblock_tpu_torch.utils import settings as PS
from improving_yolov8_cbam_swinblock_tpu_torch.utils import text_model as PT
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOWER_TOL = 1e-5
PROMPTS = ["hello low world!", "the  THE the...", "a photo of a hellhound", "low-budget hello", "Zürich 2024 été"]
HASHED = PROMPTS + ["person", "traffic light", "0", "79", "", "  spaced  ", "emoji 🚲 bike"]


@pytest.fixture(scope="module")
def tiny_vocab(tmp_path_factory):
    """HF-format vocab.json and merges.txt over the byte alphabet, its
    word-final forms and a few merges."""
    d = tmp_path_factory.mktemp("clipvocab")
    alphabet = list(PB.bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet + [ch + "</w>" for ch in alphabet])}
    merges = ["h e", "he l", "hel l", "hell o</w>", "l o", "lo w</w>", "t h", "th e</w>", "p h", "ph o"]
    for m in merges:
        vocab["".join(m.split())] = len(vocab)
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")
    return d


def tower_params(vocab_size, rng, width=32, layers=2, heads=4, proj=24, ctx=77):
    """Seeded CLIPTextTower weights in its layout: normal matrices and biases, LayerNorm scales near 1."""
    n = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    p = {"token_embedding": n(vocab_size, width), "position_embedding": n(ctx, width),
         "ln_final.w": 1 + n(width), "ln_final.b": n(width), "text_projection": n(proj, width),
         "num_heads": np.asarray(heads)}
    for i in range(layers):
        for ln in ("ln1", "ln2"):
            p[f"L{i}.{ln}.w"], p[f"L{i}.{ln}.b"] = 1 + n(width), n(width)
        for k in ("q", "k", "v", "out"):
            p[f"L{i}.attn.{k}.w"], p[f"L{i}.attn.{k}.b"] = n(width, width), n(width)
        p[f"L{i}.mlp.fc1.w"], p[f"L{i}.mlp.fc1.b"] = n(4 * width, width), n(4 * width)
        p[f"L{i}.mlp.fc2.w"], p[f"L{i}.mlp.fc2.b"] = n(width, 4 * width), n(width)
    return p


def tokenizers(d):
    return (PB.CLIPBPETokenizer(str(d / "vocab.json"), str(d / "merges.txt")),
            JB.CLIPBPETokenizer(str(d / "vocab.json"), str(d / "merges.txt")))


def test_hash_projection_equals_jax_bit_for_bit():
    got, want = PT.encode_texts(HASHED, npz_path=None), JT.encode_texts(HASHED, npz_path=None)
    assert got.dtype == np.float32 and got.shape == (len(HASHED), 512)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    assert abs(float(got[5] @ got[6])) < 0.2  # distinct prompts are near orthogonal
    np.testing.assert_array_equal(PT.encode_texts(["cat"], dim=64), JT.encode_texts(["cat"], dim=64))


def test_tokenizer_equals_jax(tiny_vocab):
    """Token ids of each prompt and the (n, 77) grid (sot, ids, eot, zeros;
    a prompt longer than the context truncated to end in eot)."""
    ours, theirs = tokenizers(tiny_vocab)
    for p in PROMPTS:
        assert ours.encode(p) == theirs.encode(p), p
    long = ["hello " * 100]
    for texts in (PROMPTS, long):
        np.testing.assert_array_equal(ours(texts), theirs(texts))
    grid = ours(long)
    assert grid.shape == (1, 77) and grid[0, 0] == ours.sot and grid[0, -1] == ours.eot
    assert ours.encode("hello") == [ours.encoder["hello</w>"]]


def test_tower_matches_jax(tiny_vocab):
    """The PyTorch tower on the CPU against JAX's on the same seeded weights and token grid."""
    ours, _ = tokenizers(tiny_vocab)
    params = tower_params(len(ours.encoder), np.random.default_rng(0))
    ids = ours(PROMPTS)
    got = PT.CLIPTextTower(params, eot_id=ours.eot, device="cpu")(ids)
    want = JT.CLIPTextTower(params, eot_id=ours.eot)(ids)
    assert got.shape == want.shape == (len(PROMPTS), 24)
    np.testing.assert_allclose(got, want, rtol=TOWER_TOL, atol=TOWER_TOL * float(np.abs(want).max()))


def write_archive(path, d, params, eot):
    np.savez(path, **params, vocab_json=(d / "vocab.json").read_text(), merges_txt=(d / "merges.txt").read_text(),
             eot_id=np.asarray(eot))


def test_archives_and_the_clip_npz_setting(tiny_vocab, tmp_path, monkeypatch):
    """A weight archive runs tokenizer and tower (within TOWER_TOL of JAX's
    encode_texts on it); a vector archive is looked up (equal to JAX's); the
    `clip_npz` setting routes a call without npz_path to its archive; the
    tower runs on the card unless the caller asks for the CPU."""
    ours, _ = tokenizers(tiny_vocab)
    arc = tmp_path / "clip_text.npz"
    write_archive(arc, tiny_vocab, tower_params(len(ours.encoder), np.random.default_rng(1)), ours.eot)
    got = PT.encode_texts(PROMPTS, npz_path=str(arc), device="cpu")
    want = JT.encode_texts(PROMPTS, npz_path=str(arc))
    assert got.shape == (len(PROMPTS), 24)
    np.testing.assert_allclose(got, want, rtol=TOWER_TOL, atol=TOWER_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    vec = tmp_path / "vectors.npz"
    np.savez(vec, **{p: np.random.default_rng(i).normal(0, 1, 12) for i, p in enumerate(["cat", "dog"])})
    np.testing.assert_array_equal(PT.encode_texts(["dog", "cat"], npz_path=str(vec)),
                                  JT.encode_texts(["dog", "cat"], npz_path=str(vec)))
    assert PS.SETTINGS.defaults["clip_npz"] == ""
    monkeypatch.setitem(PS.SETTINGS, "clip_npz", str(arc))
    np.testing.assert_array_equal(PT.encode_texts(["hello", "low"], device="cpu"),
                                  PT.encode_texts(["hello", "low"], npz_path=str(arc), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # the tower's device defaults to the card
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.encode_texts(["hello"], npz_path=str(arc))


def test_hf_state_to_params_equals_jax():
    """HF CLIPTextModelWithProjection's names (two layers) mapped to the tower's layout as JAX maps them."""
    rng = np.random.default_rng(2)
    state = {"text_model.embeddings.token_embedding.weight": rng.normal(0, 1, (10, 8)),
             "text_model.embeddings.position_embedding.weight": rng.normal(0, 1, (6, 8)),
             "text_model.final_layer_norm.weight": rng.normal(0, 1, 8),
             "text_model.final_layer_norm.bias": rng.normal(0, 1, 8),
             "text_projection.weight": rng.normal(0, 1, (4, 8))}
    for i in range(2):
        pre = f"text_model.encoder.layers.{i}"
        for name in ("layer_norm1", "layer_norm2", "self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                     "self_attn.out_proj", "mlp.fc1", "mlp.fc2"):
            state[f"{pre}.{name}.weight"] = rng.normal(0, 1, (8, 8))
            state[f"{pre}.{name}.bias"] = rng.normal(0, 1, 8)
    got, want = PT.hf_state_to_params(state, num_heads=2), JT.hf_state_to_params(state, num_heads=2)
    assert got.keys() == want.keys() and len(got) == 6 + 2 * 16
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_port_imports_no_regex_until_a_tokenizer_is_built():
    """With `regex` made unimportable, the port's text model and tokenizer
    modules import and the hash projection encodes; building a tokenizer
    then raises ImportError."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name == 'regex': raise ImportError('no regex here')\n"
            "sys.meta_path.insert(0, Block())\n"
            "from improving_yolov8_cbam_swinblock_tpu_torch.utils import clip_bpe, text_model\n"
            "print(text_model.encode_texts(['cat'], npz_path=None).shape)\n"
            "try:\n"
            "    clip_bpe.CLIPBPETokenizer('v.json', 'm.txt')\n"
            "except ImportError as e:\n"
            "    print('ImportError', e)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines() == ["(1, 512)", "ImportError no regex here"]
