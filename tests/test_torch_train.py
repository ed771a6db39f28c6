"""The port's detect train step vs the JAX package's `_make_train_step`.

yolov8n-cbam-swin (scale n) at 64 px, batch 2, fp32 (TF32 off), no `aug`
(as bench.py drives the JAX step): seeded numpy values for the JAX
variables (kernels, norms, biases, BN statistics) are carried into the port
by the weight bridge, and both trainers take two steps on the same seeded batches.
After each step the loss items agree, and after both the parameters, the BN
running statistics (biased variance, flax momentum 0.97) and the EMA of
both agree: rtol 1e-3, atol 1e-5 (the same fp32 math through ~60 layers and
their backward, summed in another order).

The optimizer is SGD (as bench.py pins it) or `auto`, which picks AdamW
(lr 0.002, no bias warmup) for a run this short. An AdamW step is about
lr * sign(g): where a gradient is rounding noise (the attention's key bias
has a gradient that is zero in exact arithmetic, a dead channel another),
its sign is not defined. So with AdamW the parameters and their EMA are held
to 2 lr of JAX's, and the optimizer's moments, which are linear in the
gradients, to 5e-3 of each tensor's largest magnitude, as are SGD's
momentum buffers (with a floor for the gradients that are rounding noise):
the gradient of an early layer, through ~60 layers and back at batch 2,
differs by up to ~1.3e-3 between the two fp32 implementations.

Each of the 7 optimizers, built as the trainer builds it (three groups,
warmup-scheduled lr and momentum), follows JAX `optimizer_update` on small
tensors to 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.cfg import get_cfg as jax_get_cfg
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import DetectionTrainer as JaxTrainer
from improving_yolov8_cbam_swinblock_tpu.engine.trainer import make_train_state, optimizer_update
from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch.engine.trainer import (
    OPTIMIZERS, DetectionTrainer, build_optimizer, set_schedule)
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
CFG = "yolov8n-cbam-swin.yaml"
IMGSZ, BATCH, NB = 64, 2, 100
RTOL, ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def variables():
    jm = JaxDetectionModel(CFG)
    return jm, seeded_variables(jm, IMGSZ, np.random.default_rng(0))


def batches(n, g=6):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        xy = rng.uniform(0.25, 0.75, (BATCH, g, 2))
        wh = rng.uniform(0.15, 0.5, (BATCH, g, 2))
        out.append({
            "img": rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8),
            "cls": np.zeros((BATCH, g), np.int32),
            "bboxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "mask": (rng.random((BATCH, g)) < 0.7).astype(np.float32),
        })
    return out


def tree_state(params, stats):
    return {k: v.numpy() for k, v in state_dict_from_jax({"params": params, "batch_stats": stats}).items()
            if not k.endswith("num_batches_tracked")}


def assert_states_match(got, ref, step_bound, what):
    """BN statistics to RTOL / ATOL; parameters too, or, where step_bound is
    set (AdamW), to within step_bound of JAX's."""
    for name, r in ref.items():
        if step_bound and not name.endswith(("running_mean", "running_var")):
            assert np.abs(got[name] - r).max() <= step_bound + ATOL, (what, name)
        else:
            np.testing.assert_allclose(got[name], r, rtol=RTOL, atol=ATOL, err_msg=f"{what} {name}")


def assert_moments_match(pt, pm, state, opt):
    """SGD's momentum buffer, AdamW's first and second moments vs JAX's
    mom_buf / var_buf, each within 5e-3 of the tensor's largest magnitude or
    1e-6 of the largest over all tensors, whichever is larger: a gradient
    that is zero in exact arithmetic (the bias of a Swin MLP whose output
    feeds a 1x1 conv and a batch-statistics BN) is rounding noise. A frozen
    parameter has no torch state and a zero JAX buffer."""
    keys = {"SGD": (("momentum_buffer", state.mom_buf),),
            "AdamW": (("exp_avg", state.mom_buf), ("exp_avg_sq", state.var_buf))}[opt]
    params = dict(pm.named_parameters())
    for key, tree in keys:
        ref = {k: t.numpy() for k, t in state_dict_from_jax({"params": tree}).items()}
        assert set(ref) == set(params)
        floor = 1e-6 * max(np.abs(r).max() for r in ref.values())
        for name, r in ref.items():
            st = pt.optimizer.state.get(params[name], {})
            if key not in st:
                assert not r.any(), (key, name)
                continue
            got = st[key].numpy()
            assert np.abs(got - r).max() <= max(5e-3 * np.abs(r).max(), floor), (key, name)


@pytest.mark.parametrize("opt,accumulate,freeze", [("SGD", 1, None), ("SGD", 2, 2), ("auto", 1, None),
                                                   ("auto", 2, None)])
def test_two_steps_match_jax(variables, opt, accumulate, freeze):
    jm, v = variables
    overrides = {"batch": BATCH, "nbs": BATCH * accumulate, "epochs": 10, "imgsz": IMGSZ, "optimizer": opt,
                 "amp": False, "freeze": freeze}  # warmup spans 300 micro-steps: both steps are in it
    data = batches(2)

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.args = jax_get_cfg(overrides=overrides)
    jt.model = jm
    jstep, jacc = jt._make_train_step(nb=NB)
    state = make_train_state(v, jt.optimizer_name)
    jitems = []
    for b in data:
        state, m = jstep(state, {k: jnp.asarray(a) for k, a in b.items()})
        jitems.append(np.asarray(m))

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pm = DetectionModel(CFG, device="cpu", dtype=torch.float32, param_dtype=torch.float32)
        pm.load_state_dict(state_dict_from_jax(v), strict=True)
        pt = DetectionTrainer(overrides=overrides, model=pm, device="cpu").setup()
        pstep, pacc = pt._make_train_step(nb=NB)
        pitems = [pstep(b).numpy() for b in data]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev

    name = "AdamW" if opt == "auto" else opt
    assert pacc == jacc == accumulate and pt.optimizer_name == jt.optimizer_name == name
    assert pt.step == int(state.step) == 2 and pt.ema_updates == int(state.ema_updates) == 2 // accumulate
    for i, (p, j) in enumerate(zip(pitems, jitems)):
        np.testing.assert_allclose(p, j, rtol=RTOL, atol=ATOL, err_msg=f"loss items of step {i}")
    assert np.all(jitems[0] > 0)

    step_bound = 2 * max(g["lr"] for g in pt.optimizer.param_groups) if name == "AdamW" else 0.0
    ref = tree_state(state.params, state.batch_stats)
    got = {k: t.detach().float().numpy() for k, t in pm.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(ref)
    assert_states_match(got, ref, step_bound, "params/BN")
    assert_states_match({k: t.numpy() for k, t in pt.ema.items()}, tree_state(state.ema_params, state.ema_stats),
                        step_bound, "EMA")
    assert_moments_match(pt, pm, state, name)

    start = {k: t.numpy() for k, t in state_dict_from_jax(v).items()}
    moved = [k for k in ref if not k.endswith(("running_mean", "running_var")) and not np.array_equal(got[k], start[k])]
    if freeze:  # frozen layers keep their parameters; every other layer moves
        assert not any(k.startswith(("model.0.", "model.1.")) for k in moved)
    assert any(k.startswith("model.7.attn") for k in moved) and any(k.startswith("model.26.") for k in moved)
    bn_var = "model.0.bn.running_var"
    assert not np.array_equal(got[bn_var], start[bn_var])  # the statistics move on every micro-step


@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_optimizers_follow_jax_update_rules(opt):
    """decay / nodecay / bias groups, four steps with their own lr and
    momentum (as the warmup schedules hand them), weight decay 5e-4 on the
    decay group only."""
    rng = np.random.default_rng(0)
    mom_f, wd = 0.9, 5e-4
    p0 = {k: rng.standard_normal(5).astype(np.float32) for k in ("decay", "nodecay", "bias")}
    params = {k: torch.nn.Parameter(torch.tensor(a)) for k, a in p0.items()}
    opt_t = build_optimizer(opt, {k: [p] for k, p in params.items()}, 0.01, mom_f, wd)
    jp = {k: jnp.asarray(a) for k, a in p0.items()}
    jb = {k: jnp.zeros(5) for k in p0}
    jv = {k: jnp.zeros(5) for k in p0}
    for t, (lr_w, lr_b, mom) in enumerate([(0.0, 0.1, 0.8), (0.002, 0.06, 0.85), (0.005, 0.02, 0.9),
                                           (0.01, 0.01, 0.9)], start=1):
        grads = {k: rng.standard_normal(5).astype(np.float32) for k in p0}
        for k, p in params.items():
            p.grad = torch.tensor(grads[k])
        set_schedule(opt_t, lr_w, lr_b, mom)
        opt_t.step()
        for k in p0:
            jp[k], jb[k], jv[k] = optimizer_update(opt, k, jp[k], jnp.asarray(grads[k]), jb[k], jv[k],
                                                   lr_b if k == "bias" else lr_w, mom, mom_f, wd, jnp.float32(t))
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6, err_msg=k)
