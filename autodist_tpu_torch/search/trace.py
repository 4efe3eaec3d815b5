"""Search trace: a deterministic, dumpable record of a search run.

The port's copy of ``autodist_tpu/search/trace.py``.

Every candidate the drivers touch lands here as one entry — seeds,
mutations (with the operator applied and the parent candidate), scores,
prune reasons, duplicates the dedup table absorbed — plus a header
carrying the :class:`~autodist_tpu_torch.search.drivers.SearchConfig` and a
result section naming the chosen plan. The trace contains **no wall-clock
data**: two runs with the same seed/config over the same model produce
byte-identical dumps (the reproducibility contract
``tests/test_search.py`` pins), and re-running from a dumped header must
re-choose the same plan. Wall time lives on
:class:`~autodist_tpu_torch.search.drivers.SearchResult` instead.
"""
import json
import os
from typing import List, Optional


class SearchTrace:
    """Append-only event log of one search run."""

    VERSION = 1

    def __init__(self, header: Optional[dict] = None):
        self.header = dict(header or {})
        self.header.setdefault("version", self.VERSION)
        self.entries: List[dict] = []
        self.result: dict = {}

    def record(self, event: str, **fields) -> dict:
        entry = {"i": len(self.entries), "event": event}
        entry.update({k: v for k, v in fields.items() if v is not None})
        self.entries.append(entry)
        return entry

    def record_score(self, label: str, record, algo: str,
                     op: Optional[str] = None,
                     parent: Optional[str] = None):
        """One scored candidate (or prune) from ``PlanScorer.score``."""
        fields = dict(label=label, algo=algo, op=op, parent=parent)
        if record.pruned is not None:
            fields["pruned"] = record.pruned
            fields["detail"] = record.detail
        else:
            fields["score_ms"] = round(record.score_s * 1e3, 6)
            fields["step_time_ms"] = round(record.step_time_s * 1e3, 6)
        return self.record("score", **fields)

    # ------------------------------------------------------------- summary

    def scored(self) -> List[dict]:
        return [e for e in self.entries if e["event"] == "score"]

    def pruned(self) -> List[dict]:
        return [e for e in self.scored() if "pruned" in e]

    def prune_reasons(self) -> dict:
        out: dict = {}
        for e in self.pruned():
            key = e["pruned"]
            out[key] = out.get(key, 0) + 1
        return out

    # ---------------------------------------------------------------- (de)ser

    def to_dict(self) -> dict:
        return {"header": dict(self.header),
                "entries": list(self.entries),
                "result": dict(self.result)}

    @classmethod
    def from_dict(cls, d: dict) -> "SearchTrace":
        trace = cls(header=d.get("header"))
        trace.entries = list(d.get("entries", []))
        trace.result = dict(d.get("result", {}))
        return trace

    def dump(self, path: str) -> str:
        """Atomic JSON dump (write-then-rename, like Strategy.serialize)."""
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "SearchTrace":
        with open(path) as f:
            return cls.from_dict(json.load(f))
