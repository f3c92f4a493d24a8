"""DegreeOptimizer: per-edge QUBO degree search over a QKAN layer.

Counterpart of ``qkan_implementation_tpu.optim.degree_optimizer``, on
the optimizer's device (the card unless the caller asks for the CPU):

- ``evaluate_degree``: the cumulative-degree least-squares sweep with MSE
  and weighted competition-R^2 scores.  ``'gram'`` (chosen by ``'auto'``
  for large problems) accumulates the Gram statistics over row chunks as
  torch products on the device in the data's dtype (float64), then
  solves every cumulative degree against the leading block on the host
  in float64; ``'svd'`` keeps numpy's min-norm ``lstsq`` on the host over
  the Chebyshev transforms (computed on the device, cached, LRU of 4);
- ``is_degree_definitive`` and ``optimize_layer``: the degree-selection
  QUBO and the annealer of ``anneal/`` on the device;
- ``fit`` / ``predict``: one-hot degree weights for the QKAN layer and
  the batched layer forward on the device;
- ``evaluate_degree_cv`` over expanding or time-window folds;
- ``analyze_network`` / ``visualize_analysis`` (matplotlib, imported by
  the plot);
- ``save_state`` / ``load_state``: the JAX package's pickled ``np.save``
  dict, so a state either package writes loads in the other.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from qkan_implementation_tpu_torch.anneal import (
    decode_degrees,
    degree_selection_qubo,
    solve_qubo,
)
from qkan_implementation_tpu_torch.ops.chebyshev import chebyshev_basis
from qkan_implementation_tpu_torch.ops.qkan_layer import (
    qkan_layer_forward_batched,
)
from qkan_implementation_tpu_torch.optim.base import (
    BaseOptimizer,
    _extract_features,
)
from qkan_implementation_tpu_torch.utils import profiling
from qkan_implementation_tpu_torch.utils.metrics import compute_metrics
from qkan_implementation_tpu_torch.utils.platform import resolve_device
from qkan_implementation_tpu_torch.utils.profiling import span


def _gram_stats(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                max_degree: int) -> tuple:
    """One row chunk's Gram statistics on x's device, in x's dtype:
    (X'X, X'y, X'WX, X'Wy, per-target y'Wy [T], sum w), X the clipped
    Chebyshev basis in degree-major column order (all features at degree
    0, then degree 1, ...)."""
    basis = chebyshev_basis(x, max_degree, clip=True)  # [c, F, D+1]
    X = basis.transpose(1, 2).reshape(x.shape[0], -1)
    Xw = X * w
    return (X.T @ X, X.T @ y, Xw.T @ X, Xw.T @ y,
            torch.sum(w * y**2, dim=0), torch.sum(w))


def _project_targets(y: np.ndarray, n_components: int) -> np.ndarray:
    """Project multi-target columns onto their top principal components.

    [n, T] -> [n, P]: center, eigendecompose the TxT covariance, keep the
    P highest-variance directions.  Pooled residual scoring is
    rotation-invariant, so this equals scoring the original targets with
    the (T - P) lowest-variance directions removed."""
    yc = y - y.mean(axis=0, keepdims=True)
    evals, evecs = np.linalg.eigh(yc.T @ yc)
    top = np.argsort(evals)[::-1][:n_components]
    return yc @ evecs[:, top]


class MetricType(Enum):
    """Supported metric types."""

    MSE = "mse"
    R2 = "r2"
    COMP_R2 = "comp_r2"


class DegreeOptimizer(BaseOptimizer):
    """Degree search for a QKAN network of ``network_shape``.

    ``device``: where the transforms, the Gram statistics, the annealer
    and the layer forward run; the card unless the caller asks for the
    CPU.
    """

    def __init__(
        self,
        network_shape: List[int],
        max_degree: int,
        complexity_weight: float = 0.1,
        significance_threshold: float = 0.05,
        target_projection: Optional[int] = None,
        device="cuda",
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.network_shape = network_shape
        self.num_layers = len(network_shape) - 1
        self.max_degree = max_degree
        self.complexity_weight = complexity_weight
        self.significance_threshold = significance_threshold
        # multi-target scoring: project [n, T] targets onto their top-P
        # principal components before pooling residuals (None pools all)
        self.target_projection = target_projection
        self.transform_cache: Dict = {}
        self.degree_scores: Dict = {}
        self.data_same = True
        self.optimal_degrees: Optional[List[List[int]]] = None
        self.feature_means: Optional[np.ndarray] = None
        self.feature_stds: Optional[np.ndarray] = None
        self.qkan_weights: Optional[np.ndarray] = None  # [D+1, N*K]
        self.qkan_weights_stack: Optional[list] = None  # full-network fit
        self.optimal_degrees_stack: Optional[list] = None

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- transforms -------------------------------------------------------
    def _compute_transforms(self, feature_data: np.ndarray) -> Dict[int, np.ndarray]:
        """Every degree's transform in one basis pass on the device:
        {d: [n, features]} on the host."""
        basis = chebyshev_basis(
            self._on_device(feature_data), self.max_degree, clip=True
        ).cpu().numpy()  # [n, F, D+1]
        return {d: basis[:, :, d] for d in range(self.max_degree + 1)}

    _TRANSFORM_CACHE_MAX = 4  # full [n, F, D+1] f64 bases: cap retention

    def _cached_transforms(self, feature_data: np.ndarray) -> Dict[int, np.ndarray]:
        key = hash(feature_data.tobytes())
        if key not in self.transform_cache:
            # LRU eviction: each entry is a whole float64 basis
            while len(self.transform_cache) >= self._TRANSFORM_CACHE_MAX:
                self.transform_cache.pop(next(iter(self.transform_cache)))
            self.transform_cache[key] = self._compute_transforms(feature_data)
        else:
            self.transform_cache[key] = self.transform_cache.pop(key)  # LRU touch
        return self.transform_cache[key]

    # -- scoring ----------------------------------------------------------
    def evaluate_degree(
        self, x_data, y_data, weights=None, method: str = "auto"
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-cumulative-degree (MSE, weighted comp-R^2) scores.

        ``method='gram'`` (chosen by ``'auto'`` when F * n * (D+1) >
        2,000,000) makes one pass of Gram statistics on the device and
        solves every cumulative degree against the leading block of the
        same Gram, residuals from the quadratic-form identity;
        ``method='svd'`` keeps exact min-norm lstsq semantics.

        ``y_data`` may be [n] or [n, T] multi-target: scores pool the
        weighted residuals across all T columns (both methods agree).
        """
        feature_data = _extract_features(x_data).astype(np.float64)
        y = _as_numpy(y_data).astype(np.float64)
        y = y.reshape(-1, 1) if y.ndim == 1 else y
        if (
            self.target_projection is not None
            and y.shape[1] > self.target_projection
        ):
            y = _project_targets(y, self.target_projection)
        if method == "auto":
            big = feature_data.size * (self.max_degree + 1) > 2_000_000
            method = "gram" if big else "svd"
        # the key covers everything the scores depend on: data, targets,
        # sample weights and the resolved method
        w_key = (
            None
            if weights is None
            else hash(np.ascontiguousarray(_as_numpy(weights)).tobytes())
        )
        cache_key = (
            feature_data.shape,
            hash(feature_data.tobytes()),
            y.shape,
            hash(y.tobytes()),
            w_key,
            method,
        )
        if cache_key in self.degree_scores and self.data_same:
            return self.degree_scores[cache_key]

        if method == "gram":
            scores, comp_r2 = self._evaluate_degree_gram(
                feature_data, y, weights
            )
        else:
            transforms = self._cached_transforms(feature_data)
            scores = np.zeros(self.max_degree + 1)
            comp_r2 = np.zeros(self.max_degree + 1)
            for d in range(self.max_degree + 1):
                X = np.hstack([transforms[deg] for deg in range(d + 1)])
                coeffs = np.linalg.lstsq(X, y, rcond=None)[0]
                y_pred = X @ coeffs
                metrics = self._compute_metrics(y, y_pred, weights)
                scores[d] = metrics["mse"]
                comp_r2[d] = metrics["comp_r2"]
        self.degree_scores[cache_key] = (scores, comp_r2)
        return scores, comp_r2

    # rows a Gram chunk: bounds the device's [chunk, F*(D+1)] basis (the
    # chunks need no padding: torch takes any shape)
    _CHUNK = 65536

    def _evaluate_degree_gram(self, feature_data, y, weights):
        """Leading-block Gram scoring (see ``evaluate_degree``)."""
        n, f = feature_data.shape
        n_targets = y.shape[1]
        dp1 = self.max_degree + 1
        w_np = (
            np.ones((n, 1))
            if weights is None
            else _as_numpy(weights).reshape(-1, 1).astype(np.float64)
        )
        with span(profiling.DOPT_GRAM):
            x_d, y_d, w_d = (self._on_device(a)
                             for a in (feature_data, y, w_np))
            stats = None
            for start in range(0, n, self._CHUNK):
                end = min(start + self._CHUNK, n)
                chunk = _gram_stats(x_d[start:end], y_d[start:end],
                                    w_d[start:end], self.max_degree)
                stats = chunk if stats is None else tuple(
                    s + c for s, c in zip(stats, chunk))
            G, b, Gw, bw, yyw, w_total = (s.cpu().numpy() for s in stats)
        yyw_sum = float(yyw.sum())
        w_total = float(w_total)

        scores = np.zeros(dp1)
        comp_r2 = np.zeros(dp1)
        with span(profiling.DOPT_SCORE):
            for d in range(dp1):
                k = (d + 1) * f
                Gd = G[:k, :k]
                ridge = 1e-10 * (np.trace(Gd) / k + 1e-30)
                c = np.linalg.solve(Gd + ridge * np.eye(k), b[:k])  # [k, T]
                # weighted residual per target via quadratic forms:
                # sum w (y - Xc)^2 = y'Wy - 2 c'X'Wy + c'X'WX c
                res_w = (
                    yyw
                    - 2 * np.einsum("kt,kt->t", c, bw[:k])
                    + np.einsum("kt,kj,jt->t", c, Gw[:k, :k], c)
                )
                # pooled over targets
                res_w = float(np.maximum(res_w, 0.0).sum())
                scores[d] = res_w / (w_total * n_targets)
                comp_r2[d] = 1.0 - res_w / yyw_sum if yyw_sum > 1e-30 else 0.0
        return scores, comp_r2

    def is_degree_definitive(self, scores: np.ndarray) -> Tuple[bool, int]:
        """Definitive-degree shortcut: the best degree beats every other
        by ``significance_threshold`` relative."""
        best_degree = int(np.argmin(scores))
        best_score = float(scores[best_degree])
        for d in range(len(scores)):
            if d != best_degree:
                score = float(scores[d])
                relative_improvement = (score - best_score) / (score + 1e-10)
                if relative_improvement < self.significance_threshold:
                    return False, best_degree
        return True, best_degree

    # -- QUBO search ------------------------------------------------------
    def optimize_layer(
        self,
        layer_idx: int,
        x_data,
        y_data,
        weights=None,
        num_reads: int = 1000,
        num_sweeps: int = 1000,
        seed: int = 0,
        scores=None,
    ) -> List[List[int]]:
        """Degrees of one layer: the QUBO over its edges, annealed on the
        device.  ``scores``: precomputed per-degree scores (e.g. from
        ``evaluate_degree_cv``); None scores in-sample."""
        input_dim = self.network_shape[layer_idx]
        output_dim = self.network_shape[layer_idx + 1]
        num_functions = input_dim * output_dim

        if scores is None:
            scores, _ = self.evaluate_degree(x_data, y_data, weights)
        else:
            scores = np.asarray(scores)
        is_definitive, definitive_degree = self.is_degree_definitive(scores)

        with span(profiling.DOPT_QUBO):
            model = degree_selection_qubo(
                scores,
                num_functions=num_functions,
                complexity_weight=self.complexity_weight,
                definitive_degree=definitive_degree if is_definitive else None,
            )
        sample, _ = solve_qubo(
            model,
            num_reads=num_reads,
            num_sweeps=num_sweeps,
            seed=seed,
            one_hot_block_size=self.max_degree + 1,
            device=self.device,
        )
        return decode_degrees(sample, input_dim, output_dim, self.max_degree)

    def optimize_network(
        self, training_data: Dict[str, np.ndarray], num_reads: int = 1000
    ) -> List[List[List[int]]]:
        """Layer-by-layer network optimization."""
        network_degrees = []
        for layer in range(self.num_layers):
            network_degrees.append(
                self.optimize_layer(
                    layer_idx=layer,
                    x_data=training_data[f"layer_{layer}_input"],
                    y_data=training_data[f"layer_{layer}_output"],
                    num_reads=num_reads,
                )
            )
        return network_degrees

    def evaluate_degree_cv(
        self,
        x_data,
        y_data,
        timestamps,
        weights=None,
        n_splits: int = 5,
        strategy: str = "expanding",
        initial_ratio: float = 0.6,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Cross-validated per-degree scores over time-based folds: each
        fold fits on its training window and scores on its validation
        window; the scores average across the folds."""
        feature_data = _extract_features(x_data).astype(np.float64)
        y = _as_numpy(y_data).astype(np.float64)
        y = y.reshape(-1, 1) if y.ndim == 1 else y
        w = None if weights is None else _as_numpy(weights).reshape(-1)

        if strategy == "expanding":
            folds = self._get_expanding_window_folds(
                timestamps, n_splits=n_splits, initial_ratio=initial_ratio
            )
        elif strategy == "time":
            folds = self._get_time_based_folds(timestamps, n_splits=n_splits)
        else:
            raise ValueError(f"Unknown strategy {strategy!r}")

        dp1 = self.max_degree + 1
        scores = np.zeros(dp1)
        comp_r2 = np.zeros(dp1)
        used = 0
        # one cached full-data basis, sliced per fold
        full = self._cached_transforms(feature_data)
        for train_mask, val_mask in folds:
            if train_mask.sum() == 0 or val_mask.sum() == 0:
                continue
            used += 1
            tr = {d: t[train_mask] for d, t in full.items()}
            va = {d: t[val_mask] for d, t in full.items()}
            y_tr, y_va = y[train_mask], y[val_mask]
            w_va = None if w is None else w[val_mask]
            for d in range(dp1):
                X_tr = np.hstack([tr[deg] for deg in range(d + 1)])
                X_va = np.hstack([va[deg] for deg in range(d + 1)])
                coeffs = np.linalg.lstsq(X_tr, y_tr, rcond=None)[0]
                metrics = self._compute_metrics(y_va, X_va @ coeffs, w_va)
                scores[d] += metrics["mse"]
                comp_r2[d] += metrics["comp_r2"]
        if used == 0:
            raise ValueError("No non-empty folds")
        return scores / used, comp_r2 / used

    # -- fit / predict ----------------------------------------------------
    @staticmethod
    def _one_hot_weights(optimal_degrees, N: int, K: int, max_degree: int):
        """One-hot degree weights: w[d, out*N + in] = 1 iff the edge's
        degree is d."""
        weights_arr = np.zeros((max_degree + 1, N * K))
        for d in range(max_degree + 1):
            for out_idx, connections in enumerate(optimal_degrees):
                for in_idx, degree in enumerate(connections):
                    if degree == d:
                        weights_arr[d, out_idx * N + in_idx] = 1.0
        return weights_arr

    def _layer_forward(self, current: np.ndarray, w_arr: np.ndarray,
                       N: int, K: int) -> np.ndarray:
        with torch.no_grad():
            out = qkan_layer_forward_batched(
                self._on_device(current), self._on_device(w_arr), N, K
            )
        return out.cpu().numpy()

    def fit(
        self, x_data, y_data, weights=None, full_network: bool = False,
        **optimize_kwargs,
    ) -> None:
        """Degree search and QKAN weight assembly.

        ``full_network=False`` optimizes layer 0 only, as the reference's
        ``fit`` does.  ``full_network=True`` optimizes every layer greedily
        on the previous layer's activations, wires the per-layer one-hot
        weights into a stack, and ``predict`` runs the whole stack.
        """
        with span(profiling.DOPT_FIT):
            feature_data = _extract_features(x_data).astype(np.float64)
            self.feature_means = feature_data.mean(axis=0)
            self.feature_stds = feature_data.std(axis=0) + 1e-8

            if not full_network or self.num_layers == 1:
                self.optimal_degrees = self.optimize_layer(
                    layer_idx=0, x_data=x_data, y_data=y_data, weights=weights,
                    **optimize_kwargs,
                )
                self.qkan_weights = self._one_hot_weights(
                    self.optimal_degrees,
                    self.network_shape[0],
                    self.network_shape[1],
                    self.max_degree,
                )
                self.qkan_weights_stack = None
                return

            current = (feature_data - self.feature_means) / self.feature_stds
            stack = []
            all_degrees = []
            for layer_idx in range(self.num_layers):
                N = self.network_shape[layer_idx]
                K = self.network_shape[layer_idx + 1]
                # deeper layers see fresh activations: clear the score cache
                self.degree_scores = {}
                degrees = self.optimize_layer(
                    layer_idx=layer_idx, x_data=current, y_data=y_data,
                    weights=weights, **optimize_kwargs,
                )
                w_arr = self._one_hot_weights(degrees, N, K, self.max_degree)
                stack.append(w_arr)
                all_degrees.append(degrees)
                current = self._layer_forward(current, w_arr, N, K)
            self.optimal_degrees = all_degrees[0]
            self.optimal_degrees_stack = all_degrees
            self.qkan_weights = stack[0]
            self.qkan_weights_stack = stack

    def predict(self, x_data) -> np.ndarray:
        """Normalize by the stored statistics and run the batched QKAN
        forward on the device; after ``fit(full_network=True)`` the whole
        layer stack runs."""
        if self.qkan_weights is None:
            raise RuntimeError("Not fitted yet")
        with span(profiling.DOPT_PREDICT):
            feature_data = _extract_features(x_data).astype(np.float64)
            current = (feature_data - self.feature_means) / self.feature_stds
            stack = self.qkan_weights_stack or [self.qkan_weights]
            for layer_idx, w_arr in enumerate(stack):
                current = self._layer_forward(
                    current, np.asarray(w_arr), self.network_shape[layer_idx],
                    self.network_shape[layer_idx + 1],
                )
            return current

    # -- analysis ---------------------------------------------------------
    def analyze_network(self, x_data, y_data) -> Dict:
        """Per-neuron contribution analysis.

        For each output neuron: fit the transforms of its selected degrees
        against the target and record the contribution; the combined fit
        is the neuron sum.  Returns {'neuron_contributions' [n_neurons,
        B], 'neuron_degrees', 'combined_fit' [B]}.
        """
        if self.optimal_degrees is None:
            raise RuntimeError("Not fitted yet")
        feature_data = _extract_features(x_data).astype(np.float64)
        y = _as_numpy(y_data).reshape(-1, 1).astype(np.float64)
        transforms = self._cached_transforms(feature_data)

        n_neurons = len(self.optimal_degrees)
        contributions = np.zeros((n_neurons, len(feature_data)))
        neuron_degrees = [max(degrees) for degrees in self.optimal_degrees]
        for neuron_idx, degrees in enumerate(self.optimal_degrees):
            blocks = [
                transforms[d]
                for d in range(max(degrees) + 1)
                if d in set(degrees)
            ]
            if not blocks:
                continue
            X = np.hstack(blocks)
            coeffs = np.linalg.lstsq(X, y, rcond=None)[0]
            contributions[neuron_idx] = (X @ coeffs).ravel()
        return {
            "neuron_contributions": contributions,
            "neuron_degrees": neuron_degrees,
            "combined_fit": contributions.sum(axis=0),
        }

    def visualize_analysis(
        self, analysis_results: Dict, x_data, y_data, save_path: str | None = None
    ):
        """Plot neuron contributions and activation strengths; returns
        the figure (matplotlib, Agg backend)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        contributions = analysis_results["neuron_contributions"]
        neuron_degrees = analysis_results["neuron_degrees"]
        combined_fit = analysis_results["combined_fit"]
        x_plot = _extract_features(x_data)[:, 0]
        y_plot = _as_numpy(y_data).ravel()
        order = np.argsort(x_plot)

        fig, (ax1, ax2) = plt.subplots(
            2, 1, figsize=(12, 10), height_ratios=[2, 1]
        )
        ax1.scatter(x_plot, y_plot, alpha=0.5, label="Original Data")
        ax1.plot(x_plot[order], combined_fit[order], "r-", label="Combined Fit")
        for i, (contrib, degree) in enumerate(zip(contributions, neuron_degrees)):
            if np.linalg.norm(contrib) > 1e-6:
                ax1.plot(
                    x_plot[order], contrib[order], "--", alpha=0.5,
                    label=f"Neuron {i} (deg={degree})",
                )
        ax1.set_title(
            "Function Approximation: Individual and Combined Contributions"
        )
        ax1.legend()
        ax1.grid(True)

        activations = np.linalg.norm(contributions, axis=1)
        colors = [f"C{d % 10}" for d in neuron_degrees]
        bars = ax2.bar(range(len(activations)), activations, color=colors)
        for bar, degree in zip(bars, neuron_degrees):
            ax2.text(
                bar.get_x() + bar.get_width() / 2.0,
                bar.get_height(),
                f"d={degree}",
                ha="center",
                va="bottom",
            )
        ax2.set_title("Neuron Activation Strengths with Selected Degrees")
        ax2.set_xlabel("Neuron Index")
        ax2.set_ylabel("Activation Strength")
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path)
        return fig

    # -- metrics ----------------------------------------------------------
    def _compute_metrics(self, y_true, y_pred, weights=None) -> Dict[str, float]:
        y = np.asarray(y_true)
        if weights is not None and y.ndim == 2 and y.shape[1] > 1:
            # multi-target: per-row weights apply to every target column
            # (pooled metrics match the gram path's residual pooling)
            weights = np.repeat(
                _as_numpy(weights).reshape(-1, 1), y.shape[1], axis=1
            )
        return compute_metrics(y_true, y_pred, weights)

    # -- persistence ------------------------------------------------------
    def save_state(self, filename: str, query_params: Dict | None = None) -> None:
        """Save optimizer state incl. QKAN weights and query params, as a
        pickled dict in ``np.save`` (the JAX package's format)."""
        if query_params is None:
            query_params = {
                "n_rows": 100000,
                "columns": ["date_id", "responder_6", "weight"]
                + [f"feature_{i:02d}" for i in range(79)],
                "sort_by": "date_id",
            }
        qkan_params = None
        if self.qkan_weights is not None:
            qkan_params = {
                "weights": self.qkan_weights.copy(),
                "feature_means": self.feature_means.copy(),
                "feature_stds": self.feature_stds.copy(),
                "optimal_degrees": [list(row) for row in self.optimal_degrees],
                "weights_stack": (
                    [w.copy() for w in self.qkan_weights_stack]
                    if self.qkan_weights_stack
                    else None
                ),
                "optimal_degrees_stack": self.optimal_degrees_stack,
            }
        state = {
            "network_shape": self.network_shape,
            "max_degree": self.max_degree,
            "complexity_weight": self.complexity_weight,
            "significance_threshold": self.significance_threshold,
            "transform_cache": {},  # transforms are cheap to rebuild
            "degree_scores": self.degree_scores,
            "query_params": query_params,
            "qkan_params": qkan_params,
        }
        np.save(filename, np.array(state, dtype=object), allow_pickle=True)

    def load_state(self, filename: str, current_query_params: dict) -> None:
        """Restore state; reuse the score cache only if the query matches.
        The file is unpickled: load only states this program wrote."""
        if not str(filename).endswith(".npy"):
            filename = str(filename) + ".npy"
        state = np.load(filename, allow_pickle=True).item()
        self.network_shape = state["network_shape"]
        self.max_degree = state["max_degree"]
        self.complexity_weight = state["complexity_weight"]
        self.significance_threshold = state["significance_threshold"]

        if state["qkan_params"] is not None:
            qp = state["qkan_params"]
            self.feature_means = qp["feature_means"]
            self.feature_stds = qp["feature_stds"]
            self.optimal_degrees = qp["optimal_degrees"]
            self.qkan_weights = qp["weights"]
            self.qkan_weights_stack = qp.get("weights_stack")
            self.optimal_degrees_stack = qp.get("optimal_degrees_stack")

        if self._validate_query(state["query_params"], current_query_params):
            self.degree_scores = state["degree_scores"]
        else:
            self.data_same = False
            self.transform_cache = {}
            self.degree_scores = {}

    @staticmethod
    def _validate_query(saved_params: dict, current_query_params: dict) -> bool:
        return (
            saved_params["n_rows"] == current_query_params["n_rows"]
            and saved_params["columns"] == current_query_params["columns"]
            and saved_params["sort_by"] == current_query_params["sort_by"]
        )


def _as_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)
