"""Cardinality estimation for plan nodes.

Counterpart of bodo_tpu/plan/stats.py, with the same estimates, so both
packages order joins alike: exact row counts from scan metadata (parquet
footers are free), textbook selectivity factors for predicates, and the
|L|·|R|/max(ndv) join formula with ndv(key) approximated by the raw row
count of the smaller (primary-key) side.

`estimate(node)` returns (est_rows, raw_rows): est is the post-filter
expectation, raw the unfiltered size of the underlying relation —
the pair is what the greedy join-ordering needs to tell "small because
the table is small" from "small because a filter is selective".
"""

from __future__ import annotations

from typing import Dict, Set, Tuple

from bodo_tpu_torch.plan import logical as L
from bodo_tpu_torch.plan.expr import (BinOp, Expr, IsIn, StrPredicate, UnOp)

# runtime-stats override installed by plan/adaptive.py:
# fn(node) -> Optional[observed rows]; estimate() consults it first so
# executed subplans feed their ACTUAL cardinality back into planning.
_runtime_override = None

# cached row counts keyed by the dataset's content signature (resolved
# file list + mtimes) — an overwritten dataset changes signature and
# naturally misses instead of reusing stale counts
_pq_rows_cache: Dict[Tuple, int] = {}
_warned_unknown: Set[str] = set()


def _dataset_sig(path) -> Tuple[Tuple, Tuple]:
    """(files, (mtime, size) stamps) of a parquet dataset: the row-count
    cache key, so an overwritten dataset misses."""
    import os

    from bodo_tpu_torch.io.parquet import _dataset_files
    files = tuple(_dataset_files(path))
    stamps = []
    for f in files:
        st = os.stat(f)
        stamps.append((st.st_mtime_ns, st.st_size))
    return files, tuple(stamps)


def _parquet_rows(path) -> int:
    try:
        sig = _dataset_sig(path)
    except Exception:
        _warned_unknown.add(str(path))
        return 1_000_000  # unknown: assume big; don't cache the guess
    hit = _pq_rows_cache.get(sig)
    if hit is not None:
        return hit
    try:
        from bodo_tpu_torch.io.parquet import footer_metadata
        n = sum(footer_metadata(f).num_rows for f in sig[0])
    except Exception:
        _warned_unknown.add(str(path))
        return 1_000_000
    _pq_rows_cache[sig] = n
    return n


def selectivity(e: Expr) -> float:
    """Textbook predicate selectivity factors (System R defaults)."""
    if isinstance(e, BinOp):
        if e.op == "&":
            return selectivity(e.left) * selectivity(e.right)
        if e.op == "|":
            sl, sr = selectivity(e.left), selectivity(e.right)
            return min(1.0, sl + sr - sl * sr)
        if e.op == "==":
            return 0.1
        if e.op in ("<", "<=", ">", ">="):
            return 0.3
        if e.op == "!=":
            return 0.9
    if isinstance(e, IsIn):
        return min(1.0, 0.1 * max(len(e.values), 1))
    if isinstance(e, StrPredicate):
        if e.kind == "eq_any":
            return min(1.0, 0.1 * max(len(e.pattern), 1))
        return 0.25
    if isinstance(e, UnOp) and e.op == "~":
        return max(0.0, 1.0 - selectivity(e.operand))
    return 0.25


def estimate(node: L.Node) -> Tuple[float, float]:
    """(estimated rows, raw underlying rows). When the adaptive layer
    has OBSERVED this subplan's cardinality (this process or the
    persistent stats store), the observation replaces the estimated
    component; the raw component keeps its structural meaning (ndv proxy
    for join_estimate) except for sources, where raw == rows."""
    if _runtime_override is not None:
        ov = _runtime_override(node)
        if ov is not None:
            est = max(float(ov), 1.0)
            if isinstance(node, (L.ReadParquet, L.ReadCsv, L.FromPandas)):
                return est, est
            return est, _estimate_impl(node)[1]
    return _estimate_impl(node)


def _estimate_impl(node: L.Node) -> Tuple[float, float]:
    if isinstance(node, L.ReadParquet):
        n = float(_parquet_rows(node.path))
        return n, n
    if isinstance(node, L.ReadCsv):
        return 100_000.0, 100_000.0  # csv has no cheap footer
    if isinstance(node, L.FromPandas):
        n = float(node.table.nrows)
        return n, n
    if isinstance(node, L.Filter):
        est, raw = estimate(node.child)
        return max(est * selectivity(node.predicate), 1.0), raw
    if isinstance(node, (L.Projection, L.Window, L.RankWindow,
                         L.AggWindow, L.Sort)):
        return estimate(node.child)
    if isinstance(node, L.Limit):
        est, raw = estimate(node.child)
        return min(float(node.n), est), raw
    if isinstance(node, (L.Aggregate, L.Distinct)):
        est, raw = estimate(node.child)
        return max(est ** 0.75, 1.0), max(est ** 0.75, 1.0)
    if isinstance(node, L.Reduce):
        return 1.0, 1.0
    if isinstance(node, L.Union):
        parts = [estimate(c) for c in node.children]
        return sum(p[0] for p in parts), sum(p[1] for p in parts)
    if isinstance(node, L.Join):
        le, lr = estimate(node.left)
        re_, rr = estimate(node.right)
        if node.how == "cross":
            return max(le * re_, 1.0), max(lr, rr)
        return join_estimate(le, lr, re_, rr), max(lr, rr)
    return 10_000.0, 10_000.0  # unknown node: neutral guess


def join_estimate(a_est: float, a_raw: float,
                  b_est: float, b_raw: float) -> float:
    """|A ⋈ B| ≈ |A|·|B| / max(ndv(key)); ndv(key) ≈ rows of the smaller
    raw side (its key is the primary key in the common FK-join shape)."""
    ndv = max(min(a_raw, b_raw), 1.0)
    return max(a_est * b_est / ndv, 1.0)
