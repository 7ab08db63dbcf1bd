"""Structured timing probes.

The reference brackets query phases with `TIMING <label>: <nanoseconds>`
lines on stdout under -DTIMING (e.g. main.cpp:3174-3178, 3336-3344), and
its Python harness regex-parses them (command.py:135-158).  We keep the
label taxonomy (`decompress2_metadata_headers`, `index_search`,
`decompress_seeking`, `decompress_iteration`, ...) for comparability, but
timing is runtime-switchable instead of a compile-time build flavor, and
probes also accumulate in-process for the eval harness.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict

_ENABLED = os.environ.get("VCFC_TIMING", "") not in ("", "0", "false")
_ECHO = True  # print TIMING lines to stdout (the reference's behavior)
_ACCUM: dict[str, int] = defaultdict(int)


def enable(on: bool = True, echo: bool | None = None) -> None:
    """Turn probes on/off; ``echo=False`` accumulates via totals() without
    printing (the harness uses this — printing inside nested probes would
    pollute query output and inflate enclosing phase timings)."""
    global _ENABLED, _ECHO
    _ENABLED = on
    if echo is not None:
        _ECHO = echo


def enabled() -> bool:
    return _ENABLED


def reset() -> None:
    _ACCUM.clear()


def totals() -> dict[str, int]:
    """Accumulated nanoseconds per label since the last reset()."""
    return dict(_ACCUM)


@contextlib.contextmanager
def suspended():
    """Temporarily disable probes: internal machinery (e.g. the bulk hit
    decoder re-parsing a stitched mini-.vcfc header) must not inflate the
    reference-taxonomy labels, which mean once-per-query phases."""
    global _ENABLED
    was = _ENABLED
    _ENABLED = False
    try:
        yield
    finally:
        _ENABLED = was


def record(label: str, ns: int) -> None:
    """Manually account ``ns`` nanoseconds to ``label`` — for phase state
    machines (e.g. the reference's seeking→iteration transition in the
    binned query, main.cpp:3276-3345) where context managers can't express
    the disjoint-phase split."""
    if not _ENABLED:
        return
    _ACCUM[label] += ns
    if _ECHO:
        print(f"TIMING {label}: {ns}", file=sys.stdout, flush=True)


@contextlib.contextmanager
def timing_probe(label: str):
    if not _ENABLED:
        yield
        return
    start = time.perf_counter_ns()
    try:
        yield
    finally:
        dur = time.perf_counter_ns() - start
        _ACCUM[label] += dur
        if _ECHO:
            print(f"TIMING {label}: {dur}", file=sys.stdout, flush=True)


@contextlib.contextmanager
def device_trace(trace_dir: str | None = None):
    """Device-side profiling: wraps ``jax.profiler.trace`` so eval runs can
    capture XLA device traces alongside the host TIMING probes (SURVEY.md §5:
    same phase taxonomy on the host side; device events come from the
    profiler).  No-op when ``trace_dir`` is falsy; view with
    ``tensorboard --logdir <dir>`` or xprof."""
    if not trace_dir:
        yield
        return
    import jax

    with jax.profiler.trace(trace_dir):
        yield
