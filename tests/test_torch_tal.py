"""The port's plain task-aligned assigner vs the JAX package's two assigners.

The inputs are those of tests/test_tal_kernel.py (nc 1, 3, 80; an empty
image; a duplicated GT), plus a case with G = 4 * max_gt, the shape mosaic
hands the assigner. The port's plain version (which the CUDA kernel is held
to on the card) must give exactly the fg mask, GT index and labels of JAX
`task_aligned_assign(use_kernel=False)` and of the Pallas kernel
`tal_assign_fused` in interpret mode; boxes within 1e-4 absolute, scores
within 1e-4 relative (atol 1e-6).
"""

import numpy as np
import pytest
import torch

import jax

from improving_yolov8_cbam_swinblock_tpu.ops.pallas.tal_kernel import tal_assign_fused
from improving_yolov8_cbam_swinblock_tpu.utils.tal import task_aligned_assign as jax_assign
from improving_yolov8_cbam_swinblock_tpu_torch.utils.tal import task_aligned_assign
from tests.test_tal_kernel import _mk

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
