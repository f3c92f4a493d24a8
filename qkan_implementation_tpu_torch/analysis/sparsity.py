"""Dataset sparsity metrics for market parquet data.

Counterpart of ``qkan_implementation_tpu.analysis.sparsity``, a rebuild of
``Sparsity_check/SparsityMetrics.py`` (reference ``:6-107``) on
pyarrow/pandas: overall/per-column/per-date null rates and null-cluster
detection (runs of consecutive nulls longer than a threshold, via the same
diff-of-transitions trick, reference ``:69-81``).  Processing is chunked so
multi-GB parquet streams without materializing.  Host work only (no
tensor); ``compute_sparsity`` imports pyarrow itself (its ``to_pandas``
needs pandas).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class SparsityMetrics:
    """Container for various sparsity metrics."""

    overall_sparsity: float
    column_sparsity: Dict[str, float]
    time_based_sparsity: Dict[str, float]
    zero_clusters: List[Tuple[int, int]]


def _null_runs(is_null: np.ndarray) -> list:
    """(start, end) of every consecutive null run in a chunk, unfiltered
    (the min-length filter happens after cross-chunk merging -- filtering
    per chunk would split boundary-spanning runs into droppable
    fragments; reference diff-of-transitions trick, :74-81)."""
    transitions = np.diff(np.concatenate([[False], is_null, [False]]).astype(np.int8))
    starts = np.where(transitions == 1)[0]
    ends = np.where(transitions == -1)[0]
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def compute_sparsity(
    data_path: str,
    chunk_size: int = 1000,
    cluster_min_len: int = 10,
    date_col: str = "date_id",
) -> SparsityMetrics:
    """Comprehensive sparsity metrics for a parquet dataset."""
    import pyarrow.parquet as pq

    pf = pq.ParquetFile(data_path)
    feature_cols = [c for c in pf.schema_arrow.names if c.startswith("feature_")]
    has_dates = date_col in pf.schema_arrow.names
    read_cols = feature_cols + ([date_col] if has_dates else [])

    total_rows = 0
    null_counts = {c: 0 for c in feature_cols}
    date_nulls: Dict[str, int] = {}
    date_counts: Dict[str, int] = {}
    zero_clusters: List[Tuple[int, int]] = []
    # per-column null run left open at the previous chunk's boundary:
    # col -> (global_start, global_end_so_far)
    open_runs: Dict[str, Tuple[int, int]] = {}

    def _emit(run):
        if run[1] - run[0] > cluster_min_len:
            zero_clusters.append(run)

    for batch in pf.iter_batches(batch_size=chunk_size, columns=read_cols):
        chunk = batch.to_pandas()
        n = len(chunk)
        offset = total_rows
        total_rows += n
        null_mask = chunk[feature_cols].isna()
        for col in feature_cols:
            col_null = null_mask[col].to_numpy()
            null_counts[col] += int(col_null.sum())
            runs = [
                (s + offset, e + offset) for s, e in _null_runs(col_null)
            ]
            pending = open_runs.pop(col, None)
            if pending is not None:
                if runs and runs[0][0] == offset and pending[1] == offset:
                    # the open run continues straight into this chunk
                    runs[0] = (pending[0], runs[0][1])
                else:
                    _emit(pending)
            if runs and runs[-1][1] == offset + n:
                # run touches the chunk end: stays open for the next chunk
                open_runs[col] = runs.pop()
            for run in runs:
                _emit(run)
        if has_dates:
            row_nulls = null_mask.sum(axis=1).to_numpy()
            for date, idx in chunk.groupby(date_col).indices.items():
                key = str(date)
                date_nulls[key] = date_nulls.get(key, 0) + int(row_nulls[idx].sum())
                date_counts[key] = date_counts.get(key, 0) + len(idx)

    for col in feature_cols:  # flush runs open at end-of-file
        if col in open_runs:
            _emit(open_runs.pop(col))

    denom = max(len(feature_cols) * total_rows, 1)
    overall = sum(null_counts.values()) / denom
    column_sparsity = {
        c: null_counts[c] / max(total_rows, 1) for c in feature_cols
    }
    time_based = {
        d: date_nulls[d] / max(len(feature_cols) * date_counts[d], 1)
        for d in date_nulls
    }
    return SparsityMetrics(
        overall_sparsity=overall,
        column_sparsity=column_sparsity,
        time_based_sparsity=time_based,
        zero_clusters=zero_clusters,
    )


def print_sparsity_analysis(metrics: SparsityMetrics) -> None:
    """Pretty-print summary (reference :89-107)."""
    print(f"Overall Sparsity: {metrics.overall_sparsity:.2%}")
    print("\nMost Sparse Columns:")
    sorted_cols = sorted(
        metrics.column_sparsity.items(), key=lambda x: x[1], reverse=True
    )
    for col, sparsity in sorted_cols[:5]:
        print(f"  {col}: {sparsity:.2%}")

    print("\nTime-based Sparsity Patterns:")
    for date in sorted(metrics.time_based_sparsity)[:5]:
        print(f"  Date {date}: {metrics.time_based_sparsity[date]:.2%}")

    print("\nLarge Zero Clusters:")
    clusters = sorted(
        metrics.zero_clusters, key=lambda x: x[1] - x[0], reverse=True
    )
    for start, end in clusters[:5]:
        print(f"  Cluster from {start} to {end} (length: {end - start})")
