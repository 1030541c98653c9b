"""Span tracer: nested context-manager timing that exports Chrome trace JSON.

A copy of ``repro.obs.trace`` for the port.  Every instrumented layer opens
named spans through the one module-level :func:`span` entry point, with the
reference's span names and arguments, so a trace of either package reads
the same::

    from repro_torch.obs import trace

    with trace.span("plan_grid", arch=cfg.name) as sp:
        ...
        sp.set(n_candidates=n)        # attach args discovered mid-span

The resulting file is the Chrome trace event format (``"X"`` complete
events with microsecond ``ts``/``dur``), which loads unmodified into
Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``; counters bumped
via :func:`count` export as ``"C"`` counter tracks.  Span nesting is purely
positional — same-thread spans nest by their (ts, dur) containment, which
is how the trace viewers render flame graphs — so the tracer keeps no
explicit parent pointers and stays a flat, lock-guarded event list
(thread-safe by construction; each event carries its thread id).

**Disabled is the default, and disabled is near-free.**  ``span()`` with no
active tracer is one module-global load plus returning a shared no-op
context manager — no clock reads, no allocation beyond the kwargs dict —
so instrumentation stays compiled into every hot path permanently
(``tests/test_torch_obs.py`` pins the disabled path).  A span times host
code: it adds no device synchronize, so around asynchronous CUDA work it
closes when the work was enqueued.  Enable with env
``REPRO_TORCH_TRACE=/path/trace.json`` (written at process exit) or
programmatically ``trace.enable(path)`` + ``write()``.  The variable is the
port's own: a process that imports both packages has two tracers, and the
reference's ``REPRO_TRACE`` never names the port's file.

:func:`validate_chrome_trace` is the schema gate on emitted artifacts:
top-level shape, per-event required fields, non-negative durations, and
proper same-thread span nesting (no partial overlap).
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Union

__all__ = ["Tracer", "enable", "disable", "enabled", "active", "span",
           "count", "counters", "write", "validate_chrome_trace", "main"]

#: env var: set to a path to trace the whole process into that file
TRACE_ENV = "REPRO_TORCH_TRACE"

#: the ts/dur unit of the Chrome trace format is microseconds
_NS_PER_US = 1e3


class _NullSpan:
    """Shared do-nothing span — what :func:`span` returns when disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    """One live ``"X"`` (complete) event; records on ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_start_ns")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end_ns = time.perf_counter_ns()
        self._tracer._record(self.name, self._start_ns, end_ns, self.args)
        return False

    def set(self, **args) -> "_Span":
        """Attach args discovered while the span is open (counts, sizes)."""
        self.args.update(args)
        return self


class Tracer:
    """Thread-safe span/counter collector exporting Chrome trace JSON."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._counters: Dict[str, float] = {}
        self._pid = os.getpid()
        self._t0_ns = time.perf_counter_ns()

    # -- recording -------------------------------------------------------------
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record(self, name: str, start_ns: int, end_ns: int,
                args: Dict[str, Any]) -> None:
        ev = {"name": name, "ph": "X", "pid": self._pid,
              "tid": threading.get_ident(),
              "ts": (start_ns - self._t0_ns) / _NS_PER_US,
              "dur": (end_ns - start_ns) / _NS_PER_US}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def count(self, name: str, n: Union[int, float] = 1) -> float:
        """Bump a named counter; also emits a ``"C"`` counter-track event."""
        ts = (time.perf_counter_ns() - self._t0_ns) / _NS_PER_US
        with self._lock:
            value = self._counters.get(name, 0) + n
            self._counters[name] = value
            self._events.append({"name": name, "ph": "C", "pid": self._pid,
                                 "tid": threading.get_ident(), "ts": ts,
                                 "args": {name: _jsonable(value)}})
        return value

    def counters(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counters)

    @property
    def n_events(self) -> int:
        with self._lock:
            return len(self._events)

    # -- export ----------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        from repro_torch.obs.metrics import provenance
        with self._lock:
            events = list(self._events)
            counters = dict(self._counters)
        return {"traceEvents": events,
                "displayTimeUnit": "ms",
                "otherData": {"provenance": provenance(),
                              "counters": counters}}

    def write(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if not path:
            raise ValueError("no trace path: pass one or construct "
                             "Tracer(path=...)")
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f)
        os.replace(tmp, path)
        return path


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars / odd types into JSON-clean values."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    item = getattr(v, "item", None)          # numpy scalar
    if callable(item):
        try:
            return item()
        except (TypeError, ValueError):
            pass
    return str(v)


# --- the module-level tracer (what instrumented code talks to) ----------------

_TRACER: Optional[Tracer] = None
_ATEXIT_REGISTERED = False
#: guards installs/removals of the process tracer (reads stay lock-free:
#: span()/count() deliberately snapshot _TRACER once, and a stale snapshot
#: during a racing disable() just records into the outgoing tracer)
_STATE_LOCK = threading.Lock()


def enable(path: Optional[str] = None) -> Tracer:
    """Install a process-wide tracer (idempotent; updates path if given)."""
    global _TRACER
    with _STATE_LOCK:
        if _TRACER is None:
            _TRACER = Tracer(path)
        elif path:
            _TRACER.path = path
        return _TRACER


def disable() -> Optional[Tracer]:
    """Remove the process-wide tracer; returns it (unwritten) if there was one."""
    global _TRACER
    with _STATE_LOCK:
        t, _TRACER = _TRACER, None
        return t


def enabled() -> bool:
    return _TRACER is not None


def active() -> Optional[Tracer]:
    return _TRACER


def span(name: str, **args):
    """A context-manager span under the process tracer (no-op when disabled)."""
    t = _TRACER
    if t is None:
        return _NULL_SPAN
    return _Span(t, name, args)


def count(name: str, n: Union[int, float] = 1) -> Optional[float]:
    """Bump a process-wide trace counter (no-op → None when disabled)."""
    t = _TRACER
    if t is None:
        return None
    return t.count(name, n)


def counters() -> Dict[str, float]:
    t = _TRACER
    return {} if t is None else t.counters()


def write(path: Optional[str] = None) -> Optional[str]:
    """Flush the process tracer to disk (no-op → None when disabled)."""
    t = _TRACER
    if t is None:
        return None
    return t.write(path)


def _atexit_write() -> None:
    t = _TRACER
    if t is not None and t.path:
        try:
            t.write()
        except OSError:
            pass


def _init_from_env() -> None:
    global _ATEXIT_REGISTERED
    path = os.environ.get(TRACE_ENV, "").strip()
    if path:
        enable(path)
        with _STATE_LOCK:
            if not _ATEXIT_REGISTERED:
                atexit.register(_atexit_write)
                _ATEXIT_REGISTERED = True


_init_from_env()


# --- schema validation (the gate on emitted artifacts) ------------------------

_REQUIRED_X = ("name", "ph", "ts", "dur", "pid", "tid")

#: clock-read granularity slack when checking same-thread span containment
_NEST_EPS_US = 0.5


def validate_chrome_trace(trace: Union[str, Dict[str, Any]]
                          ) -> Dict[str, Any]:
    """Validate a Chrome-trace-event JSON file (or loaded dict).

    Checks the contract the viewers rely on: a ``traceEvents`` list; every
    ``"X"`` event carries name/ph/ts/dur/pid/tid with numeric non-negative
    duration; and same-thread complete events form a proper nesting (each
    pair is either disjoint or contained — partial overlap means a span
    leaked across another's boundary and the flame graph would lie).
    Returns a summary dict; raises ``ValueError`` with the first violation.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            doc = json.load(f)
    else:
        doc = trace
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: want a dict with a "
                         "'traceEvents' list")
    spans: Dict[Any, List] = {}
    n_x = n_c = 0
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"event {i}: not a dict with 'ph'")
        if ev["ph"] == "X":
            for k in _REQUIRED_X:
                if k not in ev:
                    raise ValueError(f"event {i}: 'X' event missing {k!r}")
            if not isinstance(ev["ts"], (int, float)) or \
                    not isinstance(ev["dur"], (int, float)):
                raise ValueError(f"event {i}: ts/dur must be numeric")
            if ev["dur"] < 0:
                raise ValueError(f"event {i}: negative dur {ev['dur']}")
            n_x += 1
            spans.setdefault((ev["pid"], ev["tid"]), []).append(
                (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                 ev["name"]))
        elif ev["ph"] == "C":
            if "name" not in ev or "ts" not in ev:
                raise ValueError(f"event {i}: 'C' event missing name/ts")
            n_c += 1
    max_depth = 0
    for tid, ivs in spans.items():
        # sort by start, longest first on ties -> parents precede children
        ivs.sort(key=lambda s: (s[0], -(s[1] - s[0])))
        stack: List = []
        for start, end, name in ivs:
            while stack and stack[-1][1] <= start + _NEST_EPS_US:
                stack.pop()
            if stack and end > stack[-1][1] + _NEST_EPS_US:
                raise ValueError(
                    f"thread {tid}: span {name!r} [{start}, {end}] "
                    f"partially overlaps {stack[-1][2]!r} "
                    f"[{stack[-1][0]}, {stack[-1][1]}] — spans must nest")
            stack.append((start, end, name))
            max_depth = max(max_depth, len(stack))
    return {"n_events": len(doc["traceEvents"]), "n_spans": n_x,
            "n_counter_events": n_c, "n_threads": len(spans),
            "max_depth": max_depth,
            "counters": dict(doc.get("otherData", {}).get("counters", {}))}


def main(argv=None) -> int:
    """``python -m repro_torch.obs --validate PATH`` — the schema gate."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Validate a Chrome-trace-event JSON artifact.")
    ap.add_argument("--validate", metavar="PATH", required=True,
                    help="trace file to schema-check (exit 1 on violation)")
    args = ap.parse_args(argv)
    try:
        summary = validate_chrome_trace(args.validate)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        print(f"INVALID trace {args.validate}: {e}")
        return 1
    print(f"valid Chrome trace: {args.validate} "
          f"({summary['n_spans']} spans, "
          f"{summary['n_counter_events']} counter events, "
          f"depth {summary['max_depth']}, "
          f"{summary['n_threads']} thread(s))")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
