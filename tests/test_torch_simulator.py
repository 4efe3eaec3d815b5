"""autodist_tpu_torch's cost model, calibration and simulator against the
JAX package's (``simulator/{cost_model,calibration,simulator}.py``), and
the port's trace costs (``model_item.trace_forward``) against the JAX
trace's:

- trace costs, on the zoo models (lm, bert, DLRM, NCF, tp_lm, pipe_lm,
  moe_lm tiny): the model-parallel collectives per axis and cost class
  equal JAX ``collective_comm_profile`` (pipe_lm under the gpipe and the
  interleaved schedules), the products' and convolutions' output bytes
  and the batch bytes equal the JAX walk's, and the total activation
  bytes fall within ``ACT_BAND`` of JAX's (printed: torch dispatches a
  LayerNorm, a GELU or a softmax as one op where the jaxpr holds their
  elementwise parts); the FLOPs equal the closed-form count on lm and
  bert tiny and the module-by-module count on ResNetTiny, and JAX
  ``count_flops_estimate`` on an MLP, whose products are all 2-D (the
  JAX estimate overcounts any other: ROADMAP C);
- the cost model given the JAX inputs (the JAX item's variables, the
  same ``flops_per_step`` and activation bytes, ``chip_kind="cpu"`` and
  an explicit memory capacity): every ``CostBreakdown`` field and
  ``hbm_bytes`` of every ``AutoStrategy`` candidate equal JAX's within
  rtol 1e-12, on one node and on a two-level topology, and
  ``Simulator.rank`` orders the labels as JAX does with the same step
  times; a calibration fits to the JAX scales.

Test-only overrides: ``flops_per_step`` (a constructor argument of both
packages) and the cost models' ``_act_cache`` (the activation estimate),
set to the same numbers on both sides, so the arithmetic after the
traces is compared on equal inputs; the traces themselves are compared
in the first half.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_plan_models as M
from autodist_tpu.kernel.common.utils import (collective_comm_profile,
                                              count_flops_estimate)
from autodist_tpu.simulator import calibration as jcal
from autodist_tpu.simulator.cost_model import CostModel as JCostModel
from autodist_tpu.simulator.simulator import Simulator as JSimulator
from autodist_tpu.strategy.auto_strategy import \
    default_candidates as jdefault_candidates
from autodist_tpu.strategy.auto_strategy import \
    mp_candidates as jmp_candidates
from autodist_tpu.utils.axis_env import bound_axes
from autodist_tpu_torch.model_item import trace_forward
from autodist_tpu_torch.simulator import calibration as cal
from autodist_tpu_torch.simulator.cost_model import CostModel
from autodist_tpu_torch.simulator.simulator import Simulator
from autodist_tpu_torch.strategy.auto_strategy import (default_candidates,
                                                       mp_candidates)

# the port's total activation bytes over JAX's on the zoo models
# (measured 0.36 on bert tiny to 0.84 on NCF)
ACT_BAND = (0.3, 1.0)
FLOPS = 3.2e12
ACT = (2.5e8, 1.0e8, 4.0e6)
HBM = 1.5e9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = M.one_thread()
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------- trace costs


@pytest.mark.parametrize("model", M.MODELS)
def test_trace_costs_against_the_jax_trace(model):
    jitem, titem, _ = M.items(model)
    jspec, _ = M.specs("one")
    jcm = JCostModel(jitem, jspec)
    costs = titem.trace_costs
    assert costs.collectives == jcm._collective_profile()
    total, dots, batch = jcm._activation_profile()
    assert costs.dot_bytes == dots and costs.batch_bytes == batch
    ratio = costs.act_bytes / total
    print("%s: activation bytes %.0f against JAX %.0f (ratio %.3f)"
          % (model, costs.act_bytes, total, ratio))
    assert ACT_BAND[0] <= ratio <= ACT_BAND[1]
    assert (model in M.MP_MODELS) == bool(costs.collectives)


def test_interleaved_pipe_collectives_equal_jax():
    from autodist_tpu.models import pipe_lm as jpipe
    from autodist_tpu.models import tp_lm as jtp
    from autodist_tpu_torch.models import pipe_lm, tp_lm
    kw = dict(seq_len=16, batch_size=8, n_microbatches=2,
              schedule="interleaved", pp_shards=2)
    jl, jp, jb, _ = jpipe.make_train_setup(jtp.TPLMConfig.tiny(num_layers=4),
                                           **kw)
    with bound_axes():
        want = collective_comm_profile(jax.make_jaxpr(jl)(jp, jb).jaxpr)
    tl, tp, tb, _ = pipe_lm.make_train_setup(
        tp_lm.TPLMConfig.tiny(num_layers=4), **kw)
    assert trace_forward(tl, tp, tb)[2].collectives == want


def _dense_flops(tokens, d, layers, mlp, seq, vocab):
    """Forward FLOPs of a transformer's products a token: q, k, v and out
    (8 d^2), the MLP (4 d mlp), the scores and the weighted sum (4 seq d)
    each layer, and the vocab head (2 d vocab)."""
    return tokens * (layers * (8 * d * d + 4 * d * mlp + 4 * seq * d)
                     + 2 * d * vocab)


def test_flops_equal_the_closed_form():
    from autodist_tpu_torch.models import bert, lm
    _, titem, _ = M.items("lm")
    c = lm.LMConfig.tiny()
    assert titem.trace_costs.flops == _dense_flops(
        8 * 16, c.d_model, c.num_layers, c.mlp_dim, 16, c.vocab_size)
    _, titem, _ = M.items("bert")
    c = bert.BertConfig.tiny()
    # plus the MLM head's transform (2 d^2 a token)
    assert titem.trace_costs.flops == _dense_flops(
        8 * 16, c.hidden_size, c.num_layers, c.mlp_dim, 16,
        c.vocab_size) + 8 * 16 * 2 * c.hidden_size ** 2
    assert CostModel(titem, M.specs("one")[1]).flops_per_step() == \
        3 * titem.trace_costs.flops


def test_resnet_flops_equal_the_module_count():
    """Each convolution's 2 x outputs x kernel taps x C_in and the head's
    2 x outputs x features, read off a real forward's module outputs."""
    from autodist_tpu_torch.models import resnet
    from autodist_tpu_torch.models.layers import Dense
    loss_fn, params, batch, _ = resnet.make_train_setup(
        resnet.ResNetTiny, num_classes=10, image_size=32, batch_size=4,
        dtype=torch.float32)
    model = resnet.ResNetTiny(num_classes=10, dtype=torch.float32)
    count = []

    def hook(mod, inp, out):
        if isinstance(mod, resnet.Conv):
            w = mod.weight
            count.append(2 * out.numel() * w.shape[1] * w.shape[2]
                         * w.shape[3])
        else:
            count.append(2 * out.numel() * mod.weight.shape[1])
    for mod in model.modules():
        if isinstance(mod, (resnet.Conv, Dense)):
            mod.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(tuple(np.shape(batch["image"]))))
    assert trace_forward(loss_fn, params, batch)[2].flops == sum(count)


def test_flops_equal_jax_where_every_product_is_2d():
    rng = np.random.RandomState(0)
    p = {"w1": rng.randn(24, 48).astype(np.float32),
         "w2": rng.randn(48, 8).astype(np.float32)}
    batch = {"x": rng.randn(16, 24).astype(np.float32)}

    def jloss(p, b):
        return jnp.mean(jnp.tanh(b["x"] @ p["w1"]) @ p["w2"])

    def tloss(p, b):
        x = torch.as_tensor(b["x"])
        return (torch.tanh(x @ p["w1"]) @ p["w2"]).mean()

    want = count_flops_estimate(jax.make_jaxpr(jloss)(p, batch).jaxpr)
    got = trace_forward(tloss, {k: torch.from_numpy(v) for k, v in
                                p.items()}, batch)[2].flops
    assert got == want == 2 * 16 * 24 * 48 + 2 * 16 * 48 * 8


# ------------------------------------------------- the cost model, priced


def _pools(model, spec):
    jitem, _, item = M.items(model)
    jspec, tspec = M.specs(spec)
    jpool, tpool = [], []
    for (label, jb), (tlabel, b) in zip(
            jdefault_candidates() + jmp_candidates(jitem, jspec),
            default_candidates() + mp_candidates(item, tspec)):
        assert label == tlabel
        try:
            jplan = jb.build(jitem, jspec)
        except Exception:  # noqa: BLE001 — both refuse (plan verify test)
            continue
        jpool.append((label, jplan))
        tpool.append((label, b.build(item, tspec)))
    return jitem, item, jspec, tspec, jpool, tpool


def _models(model, jitem, item, jspec, tspec, cls=(JCostModel, CostModel)):
    kw = dict(chip_kind="cpu", flops_per_step=FLOPS, hbm_capacity_bytes=HBM)
    jcm, cm = cls[0](jitem, jspec, **kw), cls[1](item, tspec, **kw)
    for m in (jcm, cm):
        inner = getattr(m, "_cost_model", m)
        inner._act_cache = ACT
    return jcm, cm


FIELDS = ("compute_s", "allreduce_s", "ps_s", "latency_s", "mp_s",
          "hbm_bytes", "hbm_capacity", "overlap_exposed_s", "step_time_s")


@pytest.mark.parametrize("spec", ["one", "two"])
@pytest.mark.parametrize("model", M.MODELS)
def test_every_estimate_equals_jax(model, spec):
    jitem, item, jspec, tspec, jpool, tpool = _pools(model, spec)
    jcm, cm = _models(model, jitem, item, jspec, tspec)
    assert len(tpool) >= len(jdefault_candidates())
    for (label, jplan), (_, plan) in zip(jpool, tpool):
        want, got = jcm.estimate(jplan), cm.estimate(plan)
        for field in FIELDS:
            assert getattr(got, field) == pytest.approx(
                getattr(want, field), rel=1e-12, abs=0), (label, field)
        assert (got.overlap, got.overlap_stages, got.feasible) == \
            (want.overlap, want.overlap_stages, want.feasible), label
        assert cm.hbm_bytes(plan) == pytest.approx(jcm.hbm_bytes(jplan),
                                                   rel=1e-12)
    assert cm.opt_state_bytes() == jcm.opt_state_bytes() > 0


@pytest.mark.parametrize("spec", ["one", "two"])
@pytest.mark.parametrize("model", M.MODELS)
def test_rank_orders_the_labels_as_jax(model, spec):
    jitem, item, jspec, tspec, jpool, tpool = _pools(model, spec)
    jsim, sim = _models(model, jitem, item, jspec, tspec,
                        (JSimulator, Simulator))
    for skip in (False, True):
        want = jsim.rank(jpool, skip_projected_oom=skip)
        got = sim.rank(tpool, skip_projected_oom=skip)
        assert [r.label for r in got] == [r.label for r in want]
        np.testing.assert_allclose([r.step_time_s for r in got],
                                   [r.step_time_s for r in want],
                                   rtol=1e-12, atol=0)


def test_rank_skips_projected_oom_as_jax():
    """A capacity between the plans' footprints: the ADT501 pruning keeps
    the same labels in both packages."""
    jitem, item, jspec, tspec, jpool, tpool = _pools("dlrm", "one")
    jcm, _ = _models("dlrm", jitem, item, jspec, tspec)
    peaks = sorted(jcm.hbm_bytes(p) for _, p in jpool)
    cap = (peaks[0] + peaks[-1]) / 2
    kw = dict(chip_kind="cpu", flops_per_step=FLOPS, hbm_capacity_bytes=cap)
    jsim, sim = JSimulator(jitem, jspec, **kw), Simulator(item, tspec, **kw)
    for s in (jsim, sim):
        s._cost_model._act_cache = ACT
    want = jsim.rank(jpool, skip_projected_oom=True)
    got = sim.rank(tpool, skip_projected_oom=True)
    assert [r.label for r in got] == [r.label for r in want]
    assert 0 < len(got) < len(tpool)


def test_calibration_fits_the_jax_scales(tmp_path):
    jitem, item, jspec, tspec, jpool, tpool = _pools("lm", "one")
    jcm, cm = _models("lm", jitem, item, jspec, tspec)
    jraw = [jcm.estimate(p) for _, p in jpool[:6]]
    raw = [cm.estimate(p) for _, p in tpool[:6]]
    measured = [jcal._predict(b, (3.0, 2.0, 0.5, 1.0)) for b in jraw]
    want = jcal.fit_auto_span(jraw, measured)
    got = cal.fit_auto_span(raw, measured)
    for key, value in want.to_dict().items():
        assert got.to_dict()[key] == pytest.approx(value, rel=1e-12)
    path = got.save(str(tmp_path / "cal" / "c.json"))
    assert cal.Calibration.load(path) == got
    calibrated = CostModel(item, tspec, chip_kind="cpu",
                           flops_per_step=FLOPS, calibration=path)
    calibrated._act_cache = ACT
    assert calibrated.estimate(tpool[0][1]).compute_s == pytest.approx(
        got.compute_scale * raw[0].compute_s, rel=1e-12)


def test_unknown_card_kinds_price_as_h100():
    from autodist_tpu_torch.resource_spec import ResourceSpec
    from autodist_tpu_torch.simulator.cost_model import CHIP_PEAK_FLOPS
    _, item, _ = M.items("ncf")
    spec = ResourceSpec.from_dict({"nodes": [{
        "address": "127.0.0.1", "chief": True, "gpus": [0]}],
        "slice": {"type": "v5e"}})
    cm = CostModel(item, spec, flops_per_step=FLOPS)
    assert CHIP_PEAK_FLOPS["h100"] == 989e12
    assert cm.compute_time(1) == pytest.approx(
        FLOPS / (989e12 * 0.4), rel=1e-12)
