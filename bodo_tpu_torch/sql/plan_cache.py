"""On-disk SQL plan cache keyed by query hash.

Counterpart of bodo_tpu/sql/plan_cache.py: the parsed AST is pickled
under `config.sql_plan_cache_dir`, keyed by (query, catalog schema), and
served to a later parse of the same query. Off unless the directory is
set, by the environment variable BODO_TPU_TORCH_SQL_PLAN_CACHE_DIR. The
variable and the file names are the port's own: a file holds the port's
AST classes, and the JAX package's cache, set by its own variable, must
never serve one of its files to the port nor take one of the port's.
`stats()` counts hits and misses; the JAX package's per-session
breakdown belongs to its serving layer, which the port has not.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import threading

from bodo_tpu_torch.config import config

_stats_mu = threading.Lock()
_stats = {"hits": 0, "misses": 0}


def stats() -> dict:
    with _stats_mu:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_mu:
        _stats["hits"] = 0
        _stats["misses"] = 0


def _count(key: str) -> None:
    with _stats_mu:
        _stats[key] += 1


def _path(d: str, query: str, schema_sig: str) -> str:
    h = hashlib.sha256(("bodo_tpu_torch\0" + query + "\0" +
                        schema_sig).encode()).hexdigest()
    return os.path.join(d, f"bodo_tpu_torch-{h}.pkl")


def get(query: str, schema_sig: str):
    d = config.sql_plan_cache_dir
    if not d:
        return None
    p = _path(d, query, schema_sig)
    try:
        with open(p, "rb") as f:
            ast = pickle.load(f)
    except (OSError, pickle.PickleError, EOFError):
        _count("misses")
        return None
    _count("hits")
    return ast


def put(query: str, schema_sig: str, ast) -> None:
    d = config.sql_plan_cache_dir
    if not d:
        return
    os.makedirs(d, exist_ok=True)
    p = _path(d, query, schema_sig)
    try:
        with open(p, "wb") as f:
            pickle.dump(ast, f)
    except (OSError, pickle.PickleError):
        pass
