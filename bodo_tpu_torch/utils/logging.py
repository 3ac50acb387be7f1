"""The pandas-fallback warning.

Counterpart of bodo_tpu/utils/logging.py's warn_fallback. It always
warns: the port has no setting that silences it, so a scope that turns
the warning into an error catches every fallback.
"""

from __future__ import annotations


def warn_fallback(api: str, reason: str) -> None:
    """Emit the pandas-fallback warning (a UserWarning; bodo.pandas'
    check_args_fallback)."""
    import warnings
    warnings.warn(
        f"{api}: falling back to pandas ({reason}); this materializes "
        f"the frame on the host", stacklevel=3)
