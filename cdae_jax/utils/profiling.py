"""Profiling / tracing hooks (SURVEY §5 "Tracing").

The reference instruments wall-clock only (Timer columns, ref
src/base/timer.hpp, evaluation.hpp:109 TestTime). This build keeps those
and adds real device traces via jax.profiler: pass ``trace_dir`` to the
solver (or use the context manager here) to capture per-op XLA timelines
viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(trace_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace context; no-op when trace_dir is falsy."""
    if not trace_dir:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield


def annotate(name: str):
    """Named sub-trace (shows up as a span in the profile)."""
    return jax.profiler.TraceAnnotation(name)
