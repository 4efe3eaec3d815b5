"""The online straggler detector (PyTorch counterpart of the
``StragglerEwma`` in ``autodist_tpu/telemetry/goodput.py``, which imports
nothing of JAX).

The Runner feeds it one dispatch wall time a step and marks
``straggler/<worker>`` on the coordination service while it flags; the
chief's watchdog reads the mark and leaves a slow-but-alive worker alone
instead of recycling it (``Coordinator._is_straggling``). The rest of the
JAX module — the goodput decomposition of the span tree and the cluster
attribution — is not ported yet (ROADMAP A item 11).
"""
import math
from typing import Optional

from autodist_tpu_torch import const


class StragglerEwma:
    """Online per-dispatch straggler detector (the Runner feeds it one
    wall-time sample per dispatch). Sustained z-score outliers —
    ``ADT_STRAGGLER_Z`` sigma above the EWMA baseline for
    ``ADT_STRAGGLER_PATIENCE`` consecutive dispatches — flag this worker
    as *slow-but-alive*; recovery (one in-band sample) clears the flag.
    The EWMA ingests only non-flagged samples, so a long degradation
    cannot drag its own baseline up and hide."""

    def __init__(self, alpha: float = 0.1, zscore: Optional[float] = None,
                 patience: Optional[int] = None, warmup: int = 8):
        self.alpha = alpha
        self.zscore = (zscore if zscore is not None
                       else const.ENV.ADT_STRAGGLER_Z.val)
        self.patience = max(int(patience if patience is not None
                                else const.ENV.ADT_STRAGGLER_PATIENCE.val),
                            1)
        self.warmup = warmup
        self._mean: Optional[float] = None
        self._var = 0.0
        self._n = 0
        self._streak = 0
        self.flagged = False
        self.last_z: Optional[float] = None
        self.flags = 0

    def observe(self, dur_s: float) -> Optional[str]:
        """Ingest one dispatch wall time. Returns ``"flag"`` on the
        transition into the straggling state, ``"clear"`` on recovery,
        None otherwise (the caller emits telemetry on transitions)."""
        if self._mean is None:
            self._mean, self._n = dur_s, 1
            return None
        std = math.sqrt(max(self._var, 0.0))
        z = (dur_s - self._mean) / (std + 1e-9)
        self.last_z = z
        if self._n >= self.warmup and z > self.zscore:
            self._streak += 1
            if self._streak >= self.patience and not self.flagged:
                self.flagged = True
                self.flags += 1
                return "flag"
            return None  # an outlier must not inflate its own baseline
        self._streak = 0
        delta = dur_s - self._mean
        self._mean += self.alpha * delta
        self._var = ((1.0 - self.alpha)
                     * (self._var + self.alpha * delta * delta))
        self._n += 1
        if self.flagged:
            self.flagged = False
            return "clear"
        return None

    def stats(self) -> dict:
        return {"flagged": self.flagged, "flags": self.flags,
                "last_z": (round(self.last_z, 3)
                           if self.last_z is not None else None),
                "ewma_s": (round(self._mean, 6)
                           if self._mean is not None else None)}
