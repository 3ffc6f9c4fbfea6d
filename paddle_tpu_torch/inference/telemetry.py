"""Serving telemetry (counterpart of paddle_tpu/inference/telemetry.py):
the declarative ``StatsBase`` every stats sibling subclasses, and the
attach/export surface of ``MetricsRegistry`` the engines use. The
``TraceCollector`` timeline comes in a later slice."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

__all__ = ["StatsBase", "MetricsRegistry"]


class StatsBase:
    """Declarative counter/gauge bundle: subclasses list ``FIELDS``
    (instance slots, zero-initialized), ``DERIVED`` ({property name:
    rounding digits or None}) and optionally ``REPR`` (the headline
    fields/properties; defaults to FIELDS). ``as_dict`` exports every
    field AND every derived property."""

    FIELDS: Tuple[str, ...] = ()
    DERIVED: Dict[str, Optional[int]] = {}
    REPR: Tuple[str, ...] = ()

    __slots__ = ()

    def __init__(self):
        for f in self.FIELDS:
            setattr(self, f, 0)

    def as_dict(self) -> dict:
        out = {f: getattr(self, f) for f in self.FIELDS}
        for name, nd in self.DERIVED.items():
            v = getattr(self, name)
            out[name] = round(v, nd) if nd is not None else v
        return out

    def __repr__(self):
        parts = []
        for name in (self.REPR or self.FIELDS):
            v = getattr(self, name)
            parts.append(f"{name}={v:.4g}" if isinstance(v, float)
                         else f"{name}={v}")
        return f"{type(self).__name__}({', '.join(parts)})"


def _flatten(prefix: str, value, out: dict) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, out)
    else:
        out[prefix] = value


class MetricsRegistry:
    """One namespace for every serving metric: live ``attach``ed sources
    read at export time. ``as_dict()`` is flat ({'a.b.c': value}). (The
    JAX registry's own counters, gauges, histograms and interval views
    come with the telemetry collector in a later slice.)"""

    def __init__(self):
        self._sources: Dict[str, Any] = {}

    def attach(self, prefix: str, source) -> None:
        """Register a live source exported under ``prefix``: an object
        with ``as_dict()`` (a stats sibling) or a zero-arg callable
        returning a dict."""
        self._sources[prefix] = source

    def as_dict(self) -> dict:
        out: Dict[str, Any] = {}
        for prefix, src in self._sources.items():
            _flatten(prefix, src() if callable(src) else src.as_dict(),
                     out)
        return out
