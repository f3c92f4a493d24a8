"""Structured JSONL run records.

A copy of ``qkan_implementation_tpu.utils.run_records`` (numpy and the
standard library only).

The reference keeps raw stdout logs as its experiment record
(``output_result_*.txt``); here every trial appends one JSON line to a
``runs.jsonl`` next to the experiment outputs, so results are machine
readable (SURVEY.md section 5: "one metrics module, structured (JSONL) run
records").
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List


class RunRecorder:
    def __init__(self, path: str):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def record(self, **fields: Any) -> Dict:
        entry = {"ts": time.time(), **fields}
        with open(self.path, "a") as f:
            f.write(json.dumps(entry, default=_jsonable) + "\n")
        return entry

    def read_all(self) -> List[Dict]:
        if not self.path.exists():
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def to_jsonable(obj):
    """Recursively convert numpy scalars/arrays (and containers holding
    them) to plain Python types -- THE shared converter for every
    committed JSON record (runs.jsonl here, the n-runs evidence records
    in experiments.mnist), so serialization semantics can't diverge
    between them."""
    import numpy as np

    if isinstance(obj, dict):
        return {k: to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _jsonable(obj):
    """``json.dumps(default=...)`` hook: numpy types via the shared
    converter, anything else stringified (the JSONL log must never fail
    to serialize a record)."""
    out = to_jsonable(obj)
    return out if out is not obj else str(obj)
