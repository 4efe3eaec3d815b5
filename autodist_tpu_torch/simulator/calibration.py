"""Cost-model calibration from measured step times: the port's copy of
``autodist_tpu/simulator/calibration.py``.

The reference's AutoSync materials (``autodist/simulator/dataset/README``)
describe LEARNED <resource_spec, strategy> -> runtime models trained on
measured runs; the shipped simulator is an empty stub. Here the analytic
cost model (``cost_model.py``) gets the measured-runs treatment without a
learned black box: each cost TERM (compute, collective, host-PS link,
launch latency) carries a multiplicative scale factor, and ``fit`` finds
the scales that best explain a handful of measured (strategy, seconds)
pairs. The analytic structure stays — calibration corrects the constants
(achieved tensor-core efficiency, effective link bandwidths, real launch
overheads) that no closed form gets right on every chip/tunnel/host.

Scales persist as JSON so one measured session calibrates future
``AutoStrategy`` decisions on the same hardware
(``AutoStrategy(calibration=...)``).
"""
import dataclasses
import json
import math
from typing import Sequence

from autodist_tpu_torch.utils import logging


@dataclasses.dataclass
class Calibration:
    """Multiplicative scales for the cost model's terms. 1.0 = the
    uncalibrated analytic value."""
    compute_scale: float = 1.0   # achieved vs assumed tensor-core efficiency
    ar_scale: float = 1.0        # collective (NVLink/network ring) time
    ps_scale: float = 1.0        # host link (PCIe pull/push + NIC serving)
    latency_scale: float = 1.0   # per-collective launch overhead

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Calibration":
        return cls(**{f.name: float(d.get(f.name, 1.0))
                      for f in dataclasses.fields(cls)})

    def save(self, path: str) -> str:
        import os
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)  # a long measurement session
        # must not die on a missing directory at the very last step
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "Calibration":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _predict(breakdown, scales: Sequence[float]) -> float:
    """Step time under scaled terms — delegates to
    ``CostBreakdown.step_time_s`` on a scaled copy so the fit objective
    can never diverge from the formula simulate()/rank() use (the serial
    epilogue sum, or the exposed-tail form when the plan lowers as an
    overlapped schedule)."""
    c, a, p, l = scales
    return dataclasses.replace(
        breakdown, compute_s=breakdown.compute_s * c,
        allreduce_s=breakdown.allreduce_s * a,
        ps_s=breakdown.ps_s * p,
        mp_s=breakdown.mp_s * a,  # rides the same wire as gradient AR
        # the exposed overlap tail is wire time too — same link, same
        # bandwidth error, so the same scale corrects it
        overlap_exposed_s=breakdown.overlap_exposed_s * a,
        latency_s=breakdown.latency_s * l).step_time_s


_REGULARIZER = 1e-3


def _loss(breakdowns, measured, scales) -> float:
    # relative squared error: a 10ms model and a 200ms model weigh equally.
    # The log-space ridge term keeps UNIDENTIFIABLE scales at 1.0: a term
    # that is negligible in every measurement (e.g. launch latency under
    # millisecond steps, or an overlap tail that hides almost all wire)
    # gets no signal from the data, and without the penalty the line
    # search would walk it to an arbitrary bound.
    data = sum(((_predict(b, scales) - t) / t) ** 2
               for b, t in zip(breakdowns, measured))
    reg = _REGULARIZER * sum(math.log(s) ** 2 for s in scales)
    return data + reg


def fit(breakdowns: Sequence, measured_s: Sequence[float],
        span: float = 30.0, rounds: int = 12) -> Calibration:
    """Fit term scales by coordinate descent with golden-section line
    search in log-space (deterministic, numpy-free, a few hundred model
    evaluations). ``span`` bounds each scale to [1/span, span] — a
    measured time explained only by a 100x bandwidth error is noise, not
    signal. A term that no measurement exercises (e.g. ps_s == 0
    everywhere) keeps scale 1.0."""
    if len(breakdowns) != len(measured_s) or not breakdowns:
        raise ValueError("need equal, nonzero numbers of breakdowns and "
                         "measured times")
    if not all(t > 0 and math.isfinite(t) for t in measured_s):
        # NaN passes a `t <= 0` check and would silently corrupt every
        # golden-section comparison downstream
        raise ValueError("measured times must be positive finite seconds")
    scales = [1.0, 1.0, 1.0, 1.0]
    # ar_scale covers everything on the collective wire (allreduce_s,
    # mp_s AND the overlapped schedule's exposed tail — _predict applies
    # it to all three), so an mp-only or overlap-only measurement set
    # still exercises it
    terms = [lambda b: b.compute_s, lambda b: b.allreduce_s + b.mp_s,
             lambda b: b.ps_s, lambda b: b.latency_s]
    gr = (math.sqrt(5.0) - 1.0) / 2.0

    def golden(idx: int) -> float:
        lo, hi = -math.log(span), math.log(span)

        def f(x):
            trial = list(scales)
            trial[idx] = math.exp(x)
            return _loss(breakdowns, measured_s, trial)
        x1 = hi - gr * (hi - lo)
        x2 = lo + gr * (hi - lo)
        f1, f2 = f(x1), f(x2)
        for _ in range(40):
            if f1 < f2:
                hi, x2, f2 = x2, x1, f1
                x1 = hi - gr * (hi - lo)
                f1 = f(x1)
            else:
                lo, x1, f1 = x1, x2, f2
                x2 = lo + gr * (hi - lo)
                f2 = f(x2)
        return math.exp((lo + hi) / 2.0)

    for _ in range(rounds):
        for idx in range(4):
            if all(terms[idx](b) == 0.0 for b in breakdowns):
                continue  # unexercised term: leave at 1.0
            scales[idx] = golden(idx)
    cal = Calibration(*scales)
    logging.info("calibration fit over %d measurements: %s (residual "
                 "rel-rmse %.3f)", len(measured_s), cal.to_dict(),
                 rel_rmse(breakdowns, measured_s, cal))
    return cal


def rel_rmse(breakdowns, measured_s, cal: Calibration) -> float:
    """Root-mean-square RELATIVE prediction error of a calibration over
    measurements (0.1 = predictions within ~10%)."""
    scales = (cal.compute_scale, cal.ar_scale, cal.ps_scale,
              cal.latency_scale)
    return math.sqrt(sum(((_predict(b, scales) - t) / t) ** 2
                         for b, t in zip(breakdowns, measured_s))
                     / len(measured_s))


def fit_auto_span(breakdowns, measured_s,
                  spans=(30.0, 1e3, 1e5)) -> Calibration:
    """fit() with automatic span expansion: the tight default span keeps
    noise from masquerading as a 100x constant error, but on hardware
    whose step times are STRUCTURALLY far from the analytic terms (e.g. a
    host-dispatch-dominated CPU mesh, where per-step overhead is 1000x
    the modeled wire time) every scale saturates at the bound and the fit
    explains nothing. When the residual stays above 50% the span expands
    — with a warning, because needing it means the analytic model's
    structure, not just its constants, is off for this hardware."""
    cal = None
    for span in spans:
        cal = fit(breakdowns, measured_s, span=span)
        if rel_rmse(breakdowns, measured_s, cal) <= 0.5:
            if span != spans[0]:
                logging.warning(
                    "calibration needed scale span %g — measured times are "
                    "structurally far from the analytic terms on this "
                    "hardware; treat ranking as measurement-driven, not "
                    "model-driven", span)
            return cal
    logging.warning("calibration residual stays >50%% even at span %g; "
                    "the fitted model explains these measurements poorly",
                    spans[-1])
    return cal
