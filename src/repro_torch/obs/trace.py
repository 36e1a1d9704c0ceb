"""Host-side span tracer emitting Chrome trace-event JSON.

The PyTorch counterpart of ``repro.obs.trace``.  The output file loads in
Perfetto (https://ui.perfetto.dev) or chrome://tracing.  Three event kinds:

  "X"  complete event  — a span with ts+dur (microseconds), from
                         ``Tracer.span(...)`` used as a context manager
  "i"  instant event   — a point-in-time marker from ``Tracer.instant(...)``
  "C"  counter event   — a sampled value track from ``Tracer.counter(...)``

A disabled tracer costs one attribute check per span; spans are plain dict
appends, with no locks and no I/O until ``write()``.

The JAX module's ``compile_watch`` listens to JAX's compile log and turns
each mid-run trace or XLA compile into a "compile" span.  Eager PyTorch has
no counterpart: nothing retraces, so there is nothing to listen to.  What
the port compiles is its CUDA kernels, once, at their first use
(``kernels/build.py``); the serving launcher builds them before it serves
and records that build as one ``compile_span`` when ``--trace`` is on, so
the trace separates building from serving as the JAX trace separates
compiling from serving.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List


def _jsonable(o: Any):
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


def _finite(o: Any):
    """NaN/Inf are not valid JSON: stringify them (quarantine args carry
    poisoned numeric stats) so the file stays Perfetto-parseable."""
    if isinstance(o, float) and not math.isfinite(o):
        return repr(o)
    if isinstance(o, dict):
        return {k: _finite(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [_finite(v) for v in o]
    return o


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self._tracer = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = self._tracer._clock()
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        self._tracer.events.append({
            "name": self._name, "ph": "X", "ts": self._t0 * 1e6,
            "dur": (t1 - self._t0) * 1e6, "pid": self._tracer._pid,
            "tid": 0, "cat": self._cat, "args": self._args,
        })
        return False


class Tracer:
    """Appends Chrome trace events to an in-memory list; ``write()`` dumps
    a Perfetto-loadable ``{"traceEvents": [...]}`` JSON file."""

    __slots__ = ("enabled", "events", "_pid", "_clock")

    def __init__(self, enabled: bool = True, clock=time.perf_counter):
        self.enabled = enabled
        self.events: List[Dict[str, Any]] = []
        self._pid = os.getpid()
        self._clock = clock

    def span(self, name: str, cat: str = "serve", **args):
        """Context manager recording an "X" complete event on exit."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "serve", **args) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "i", "ts": self._clock() * 1e6,
            "pid": self._pid, "tid": 0, "cat": cat, "s": "t", "args": args,
        })

    def counter(self, name: str, cat: str = "serve", **values) -> None:
        if not self.enabled:
            return
        self.events.append({
            "name": name, "ph": "C", "ts": self._clock() * 1e6,
            "pid": self._pid, "tid": 0, "cat": cat, "args": values,
        })

    def compile_span(self, name: str, dur_s: float, kind: str) -> None:
        """Backdated span ending now: a build's duration is known only
        after it."""
        if not self.enabled:
            return
        t1 = self._clock()
        self.events.append({
            "name": "compile", "ph": "X", "ts": (t1 - dur_s) * 1e6,
            "dur": dur_s * 1e6, "pid": self._pid, "tid": 1, "cat": "compile",
            "args": {"fn": name, "kind": kind},
        })

    def span_kinds(self) -> set:
        return {e["name"] for e in self.events}

    def write(self, path: str) -> None:
        events = [dict(e, args=_finite(e.get("args", {})))
                  for e in self.events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"},
                      f, default=_jsonable)


NULL_TRACER = Tracer(enabled=False)
