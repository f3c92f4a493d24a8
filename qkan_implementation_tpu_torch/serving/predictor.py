"""Bucketed batched inference over FixedKAN checkpoints, on torch.

Counterpart of ``qkan_implementation_tpu.serving.predictor``.  Requests
are padded up to power-of-two batch buckets (a non-power-of-two
``max_batch`` is the terminal bucket) and results sliced back, so the
card only ever sees a bounded set of shapes; ``warmup`` runs each once.
Latency is taken from the host copy of the input to the output back on
the host, after a device synchronise, so it is the card's time and not
the launch's.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from qkan_implementation_tpu_torch.models.fixed_kan import FixedKAN


class BatchedPredictor:
    def __init__(
        self,
        model: Union[FixedKAN, str, os.PathLike],
        max_batch: int = 4096,
        dtype: torch.dtype = torch.float32,
        device=None,
    ):
        """With a checkpoint path ``device`` defaults to the card
        (``"cuda"``; the CPU must be asked for); with a model it defaults
        to the model's device and must match it if given."""
        if isinstance(model, (str, os.PathLike)):
            model = FixedKAN.load_model(
                model, device="cuda" if device is None else device
            )
        elif device is not None and torch.device(device) != model.device:
            raise ValueError(
                f"model lives on {model.device}, not on {device}"
            )
        if model.params is None:
            raise ValueError("Model has no parameters; run optimize() first")
        if not isinstance(max_batch, int) or max_batch < 1:
            raise ValueError(
                f"max_batch must be a positive int, got {max_batch!r}"
            )
        self.model = model
        self.device = model.device
        self.dtype = dtype
        self.max_batch = max_batch
        self.buckets = []
        b = 1
        while b <= max_batch:
            self.buckets.append(b)
            b *= 2
        if self.buckets[-1] != max_batch:
            # non-power-of-two max_batch: keep it as the terminal bucket so
            # every n <= max_batch is servable
            self.buckets.append(max_batch)
        self._latencies: List[float] = []
        self._served = 0  # monotonically increasing, unlike the trimmed window
        # the HTTP server runs requests on threads: guard the stats
        self._stats_lock = threading.Lock()

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"Batch {n} exceeds max_batch {self.max_batch}")

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = self.model(x)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    def warmup(self, input_dim: Optional[int] = None) -> None:
        """Run every bucket shape once (call before taking traffic)."""
        if input_dim is None:
            input_dim = self.model.config.network_shape[0]
        for b in self.buckets:
            self._apply(
                torch.zeros((b, input_dim), dtype=self.dtype, device=self.device)
            )

    def predict(self, inputs) -> np.ndarray:
        # one cast straight to the serving dtype: a float64 predictor must
        # not round-trip its inputs through float32, and a float32 array
        # is not widened on the way
        x = torch.as_tensor(np.asarray(inputs)).to(self.dtype)
        if x.ndim == 1:
            x = x[None, :]
        in_dim = self.model.config.network_shape[0]
        if x.ndim != 2 or x.shape[1] != in_dim:
            raise ValueError(
                f"Expected inputs of shape [n, {in_dim}], got "
                f"{tuple(x.shape)}"
            )
        n = x.shape[0]
        bucket = self._bucket_for(n)
        if bucket != n:
            x = torch.cat([x, x.new_zeros((bucket - n, in_dim))])
        start = time.perf_counter()
        out = self._apply(x.to(self.device))[:n].cpu().numpy()
        elapsed = time.perf_counter() - start
        with self._stats_lock:
            self._latencies.append(elapsed)
            self._served += 1
            if len(self._latencies) > 1000:
                del self._latencies[:-1000]
        return out

    def stats(self) -> Dict[str, float]:
        with self._stats_lock:
            served = self._served
            lat_copy = list(self._latencies)
        if not lat_copy:
            return {"requests": served}
        lat = np.array(lat_copy)
        return {
            "requests": served,
            "latency_mean_ms": float(lat.mean() * 1e3),
            "latency_p50_ms": float(np.percentile(lat, 50) * 1e3),
            "latency_p99_ms": float(np.percentile(lat, 99) * 1e3),
        }
