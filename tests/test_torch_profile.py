"""FLOPs, model info, profiling and autobatch of the port (utils/model_utils.py, utils/benchmarks.py) vs JAX.

get_flops counts products: 2 x the multiply-adds of every convolution,
matmul and SwinBlock (padded windows). Its JAX counterpart here is the same
count taken from the JAX package's forward: every conv_general_dilated and
dot_general equation of its jaxpr (jax.make_jaxpr, no compile), nested
jaxprs included. They must be equal, exactly, on yolov8n-cbam-swin and
yolo11n-cbam-swin at 64 px (the SwinBlock's 4x4 grid padded to one 7x7
window) and 224 px (14x14, two whole windows a side). The JAX package's own
get_flops is XLA's cost analysis, which counts elementwise work too
(ROADMAP.md Queue 3 records the deviation). model_info's parameters equal
the JAX model's param_count on the same seeded variables.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from improving_yolov8_cbam_swinblock_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from improving_yolov8_cbam_swinblock_tpu_torch import DetectionModel, DetectionTrainer
from improving_yolov8_cbam_swinblock_tpu_torch.utils import model_utils as MU
from improving_yolov8_cbam_swinblock_tpu_torch.utils.benchmarks import ProfileModels
from improving_yolov8_cbam_swinblock_tpu_torch.utils.jax_import import state_dict_from_jax
from tests.test_torch_model import seeded_variables
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

jax.config.update("jax_platforms", "cpu")
GRAPHS = ("yolov8n-cbam-swin.yaml", "yolo11n-cbam-swin.yaml")


def _subjaxprs(eqn):
    """(jaxpr, repeats) of each jaxpr nested in an equation's parameters
    (pjit, custom_jvp / custom_vjp calls, remat, scan bodies times their
    length)."""
    reps = eqn.params.get("length", 1) if eqn.primitive.name == "scan" else 1
    for v in eqn.params.values():
        for item in v if isinstance(v, (tuple, list)) else (v,):
            if isinstance(item, jax.extend.core.ClosedJaxpr):
                yield item.jaxpr, reps
            elif isinstance(item, jax.extend.core.Jaxpr):
                yield item, reps


def jaxpr_product_flops(jaxpr) -> int:
    """2 x the multiply-adds of every conv_general_dilated and dot_general."""
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        out = math.prod(eqn.outvars[0].aval.shape)
        if name == "dot_general":
            (lhs_contract, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += 2 * out * math.prod(lhs[d] for d in lhs_contract)
        elif name == "conv_general_dilated":
            rhs = eqn.invars[1].aval.shape
            spec = eqn.params["dimension_numbers"].rhs_spec  # (out features, in features, *spatial)
            total += 2 * out * rhs[spec[1]] * math.prod(rhs[d] for d in spec[2:])
        for sub, reps in _subjaxprs(eqn):
            total += reps * jaxpr_product_flops(sub)
    return total


@pytest.fixture(scope="module", params=GRAPHS)
def both(request):
    jm = JaxDetectionModel(request.param)
    v = seeded_variables(jm, 64, np.random.default_rng(0))
    pm = DetectionModel(request.param, device="cpu")
    pm.load_state_dict(state_dict_from_jax(v), strict=True)
    return jm, v, pm


@pytest.mark.parametrize("imgsz", [64, 224])
def test_get_flops_equals_the_jaxpr_product_count(both, imgsz):
    jm, v, pm = both
    jaxpr = jax.make_jaxpr(lambda vv, x: jm.apply(vv, x, train=False))(v, jnp.zeros((1, imgsz, imgsz, 3)))
    ref = jaxpr_product_flops(jaxpr.jaxpr)
    assert ref > 0
    assert round(MU.get_flops(pm, imgsz) * 1e9) == ref


def test_model_info_parameters_equal_jax_param_count(both):
    jm, v, pm = both
    info = MU.model_info(pm, imgsz=64, verbose=False)
    assert info["parameters"] == jm.param_count(v)
    assert info["layers"] == len(jm.specs) and info["GFLOPs"] == round(MU.get_flops(pm, 64), 2)


def test_swin_formula_counts_padded_windows():
    """One 4x4 grid pads to one 7x7 window; 14x14 is four whole windows."""
    c = 128
    per_token = 24 * c * c + 196 * c
    assert MU.swin_window_flops((1, 4, 4, c)) == 49 * per_token
    assert MU.swin_window_flops((2, 14, 14, c)) == 2 * 196 * per_token


def test_profile_models_rows_on_the_cpu(capsys):
    rows = ProfileModels(["yolov8n-cbam-swin.yaml"], num_timed_runs=3, num_warmup_runs=1, imgsz=64,
                         device="cpu").profile()
    assert len(rows) == 1
    r = rows[0]
    assert set(r) == {"model", "imgsz", "params_M", "GFLOPs", "ms_mean", "ms_std"}
    assert r["imgsz"] == 64 and r["params_M"] == round(3580469 / 1e6, 2) and r["GFLOPs"] == 0.12
    assert r["ms_mean"] > 0 and r["ms_std"] >= 0
    assert "yolov8n-cbam-swin.yaml" in capsys.readouterr().out
    clipped = ProfileModels.iterative_sigma_clipping(np.array([1.0] * 9 + [50.0]))
    assert len(clipped) == 9


@pytest.mark.parametrize("per_image,limit,expect", [
    (1e9, 80e9, 32),  # 32 GB fits in 48, 64 GB does not
    (1e6, 80e9, 256),  # every candidate fits: max_batch
    (100e9, 80e9, 1),  # not even 2 fits
    (0.2e9, 10e9, 16),  # 16 x 0.2 = 3.2 <= 6; 32 x 0.2 = 6.4 > 6
])
def test_autobatch_picks_the_largest_power_of_two_that_fits(per_image, limit, expect):
    seen = []

    def measure(b):
        seen.append(b)
        return b * per_image

    assert MU.autobatch(None, imgsz=640, measure=measure, limit=limit) == expect
    assert seen == [2 ** i for i in range(1, len(seen) + 1)] and seen[-1] <= 256


def test_autobatch_stops_at_out_of_memory():
    def measure(b):
        if b >= 16:
            raise torch.cuda.OutOfMemoryError("stub")
        return 1

    assert MU.autobatch(None, measure=measure, limit=1e12) == 8
    with pytest.raises(ValueError, match="CPU"):
        MU.autobatch(DetectionModel("yolov8n-cbam-swin.yaml", device="cpu"))


def test_trainer_autobatch_and_profile_at_setup(monkeypatch, capsys):
    """batch=-1 takes check_train_batch_size's batch before the step is
    built (accumulation from it); profile=True prints the per-layer table."""
    calls = []
    monkeypatch.setattr(MU, "check_train_batch_size", lambda model, **kw: calls.append(kw) or 4)
    tr = DetectionTrainer(overrides={"model": "yolov8n-cbam-swin.yaml", "batch": -1, "nbs": 8, "imgsz": 64,
                                     "profile": True}, device="cpu").setup()
    assert calls == [{"imgsz": 64, "amp": True}] and tr.args.batch == 4
    _, accumulate = tr._make_train_step(nb=10)
    assert accumulate == 2
    out = capsys.readouterr().out
    assert "autobatch: batch=4" in out and " Detect " in out and "SwinBlock" in out
    rows = MU.profile_layers(tr.model, imgsz=64, iters=1, verbose=False)
    assert [r["i"] for r in rows] == list(range(len(tr.model.model))) and tr.model.training
    assert rows[-1]["out"] == (1, 5, 84) and sum(r["params"] for r in rows) == sum(
        p.numel() for p in tr.model.parameters())


def test_profile_times_the_block():
    with MU.Profile(device="cpu") as p:
        sum(range(1000))
    assert p.dt > 0 and p.t == p.dt and str(p).endswith("s")
