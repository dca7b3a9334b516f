"""The canonical converged read of an engine, for the read plane's
checks; ``engine_class`` (``server/serving.py``) names a family's engine.

Counterpart of the engine half of ``fluidframework_tpu/testing/chaos.py``:
:func:`digest` reads every doc of an engine the family's way."""

from __future__ import annotations

from typing import Any, Dict, List

from ..server.serving import engine_class

__all__ = ["digest", "engine_class"]


def digest(engine, family: str, docs: List[str]) -> Dict[str, Any]:
    """Canonical converged read of every doc (flushes first)."""
    engine.flush()
    read = getattr(engine, {"string": "read_text", "map": "read_doc",
                            "matrix": "to_lists", "tree": "to_dict"}[family])
    return {d: read(d) for d in docs}
