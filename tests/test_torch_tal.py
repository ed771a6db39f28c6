"""The port's plain task-aligned assigner vs the JAX package's two assigners.

The inputs are those of tests/test_tal_kernel.py (nc 1, 3, 80; an empty
image; a duplicated GT), plus a case with G = 4 * max_gt, the shape mosaic
hands the assigner. The port's plain version (which the CUDA kernel is held
to on the card) must give exactly the fg mask, GT index and labels of JAX
`task_aligned_assign(use_kernel=False)` and of the Pallas kernel
`tal_assign_fused` in interpret mode; boxes within 1e-4 absolute, scores
within 1e-4 relative (atol 1e-6). Two cases pin the rules that the CUDA
kernel must reproduce without the dense (G, A) plane: the zero fill of the
top-k (fewer than K anchors with align > 0: the first-index argmax picks the
lowest other indices, which count where they are candidates) and an anchor
claimed by several GTs with overlap 0 (it goes to GT 0, even where GT 0 does
not contain it or is masked out).
"""

import numpy as np
import pytest
import torch

import jax

from improving_yolov8_cbam_swinblock_tpu.ops.pallas.tal_kernel import tal_assign_fused
from improving_yolov8_cbam_swinblock_tpu.utils.tal import task_aligned_assign as jax_assign
from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import select_candidates_in_gts, task_aligned_assign
from tests.test_tal_kernel import _mk
from tests.test_torch_cuda import tal_edge_case

jax.config.update("jax_platforms", "cpu")

CASES = [(1, 12, 0), (80, 8, 1), (3, 16, 2), (1, 4 * 8, 3)]  # (nc, G, seed); the last: G = 4 * max_gt 8


def check(ref, got):
    np.testing.assert_array_equal(np.asarray(ref.fg_mask), got.fg_mask.numpy())
    np.testing.assert_array_equal(np.asarray(ref.target_gt_idx), got.target_gt_idx.numpy())
    np.testing.assert_array_equal(np.asarray(ref.target_labels), got.target_labels.numpy())
    np.testing.assert_allclose(got.target_bboxes.numpy(), np.asarray(ref.target_bboxes), atol=1e-4)
    np.testing.assert_allclose(got.target_scores.numpy(), np.asarray(ref.target_scores), rtol=1e-4, atol=1e-6)


def port_assign(args, nc):
    targs = [torch.tensor(np.asarray(a)) for a in args]
    out = task_aligned_assign(*targs, topk=10, num_classes=nc)
    assert out.fg_mask.dtype == torch.bool and out.target_labels.dtype == torch.int32
    return out


@pytest.mark.parametrize("nc,g,seed", CASES)
def test_plain_matches_jax_xla(nc, g, seed):
    args = _mk(nc=nc, g=g, seed=seed)
    got = port_assign(args, nc)
    check(jax_assign(*args, topk=10, num_classes=nc, use_kernel=False), got)
    assert got.fg_mask.any() and not got.fg_mask[0].any()  # image 0 has no GT


@pytest.mark.parametrize("nc,g,seed", CASES)
def test_plain_matches_pallas_interpret(nc, g, seed):
    args = _mk(nc=nc, g=g, seed=seed)
    check(tal_assign_fused(*args, topk=10, num_classes=nc, interpret=True), port_assign(args, nc))


def test_dispatcher_rules():
    args = [torch.tensor(np.asarray(a)) for a in _mk(nc=1, g=4, seed=4)]
    with pytest.raises(ValueError, match="impl"):
        task_aligned_assign(*args, num_classes=1, impl="cuda")
    # the plain version takes any (alpha, beta); only the kernel has them built in
    out = task_aligned_assign(*args, num_classes=1, alpha=1.0, beta=4.0)
    assert out.target_scores.shape == (3, args[0].shape[1], 1)


@pytest.mark.parametrize("case", ["zero_fill", "zero_multi"])
def test_plain_matches_jax_on_zero_fill_and_zero_overlap_claims(case):
    args, _, topk = tal_edge_case(case)
    nc = args[0].shape[2]
    got = port_assign(args, nc)
    check(jax_assign(*args, topk=topk, num_classes=nc, use_kernel=False), got)
    check(tal_assign_fused(*args, topk=topk, num_classes=nc, interpret=True), got)
    # the rule is exercised: positives among the lowest anchor indices, where
    # every prediction lies far from the top-left GTs (align 0)
    low = got.fg_mask[:, :topk]
    assert low.any(0).sum() >= 5
    if case == "zero_multi":  # those inside two GTs go to GT 0, which does not contain them
        cand = select_candidates_in_gts(torch.tensor(args[2]), torch.tensor(args[4]))[:, :, :topk]
        multi = low & (cand[:, 1:].sum(1) >= 2)
        assert multi.sum() >= 8 and (got.target_gt_idx[:, :topk][multi] == 0).all() and not cand[:, 0][multi].any()


def test_loss_passes_the_grid_of_its_anchor_points(monkeypatch):
    """The grid the loss hands the assigner describes the anchor points it
    hands it: their cell centres (i + 0.5) * stride, level after level,
    row-major, bit for bit (else the kernel scans every anchor), here on a
    64x96 rect batch."""
    from improving_yolov8_cbam_swinblock_tpu_torch.utils import loss as L

    seen = {}

    def spy(*args, **kw):
        seen["anc"], seen["grid"] = args[2], kw["grid"]
        return task_aligned_assign(*args, **kw)

    monkeypatch.setattr(L, "task_aligned_assign", spy)
    rng = np.random.default_rng(0)
    feats = [torch.tensor(rng.normal(0, 1, (2, 64 + 2, 64 // s, 96 // s)).astype(np.float32)) for s in (8, 16, 32)]
    L.detection_loss(feats, torch.zeros(2, 3), torch.full((2, 3, 4), 0.3), torch.ones(2, 3), nc=2)
    want = np.concatenate([np.stack(np.meshgrid((np.arange(w) + 0.5) * s, (np.arange(h) + 0.5) * s), -1).reshape(-1, 2)
                           for h, w, s in seen["grid"]]).astype(np.float32)
    assert [g[:2] for g in seen["grid"]] == [(8, 12), (4, 6), (2, 3)]
    np.testing.assert_array_equal(seen["anc"].numpy(), want)
