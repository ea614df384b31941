"""Prometheus text-exposition helper shared by the node and network
``/metrics`` handlers (the port's own copy of :mod:`pygrid_tpu.utils.metrics`) (the reference has no structured metrics at all —
SURVEY §5.5)."""

from __future__ import annotations

import math


def _escape(value) -> str:
    """Prometheus label-value escaping — one bad value must not corrupt
    the whole scrape."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _fmt(value) -> str:
    """Sample/``le`` value formatting: ``+Inf`` for infinity, ``%g``
    otherwise (Prometheus accepts scientific notation)."""
    v = float(value)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return f"{v:g}"


class Exposition:
    """Collects metric families and renders them GROUPED: one HELP/TYPE
    per name, and all of a family's samples contiguous, no matter what
    order callers mixed them in (interleaved family groups fail a strict
    Prometheus parse just like a second HELP line does)."""

    def __init__(self, prefix: str = "pygrid") -> None:
        self.prefix = prefix
        #: full name -> (help, type, [sample lines]) in declaration order
        self._families: dict[str, tuple[str, str, list[str]]] = {}

    def _family(self, full: str, help_: str, type_: str) -> list[str]:
        entry = self._families.get(full)
        if entry is None:
            entry = self._families[full] = (help_, type_, [])
        return entry[2]

    @staticmethod
    def _labels(labels: dict | None) -> str:
        if not labels:
            return ""
        inner = ",".join(
            f'{k}="{_escape(v)}"' for k, v in labels.items()
        )
        return "{" + inner + "}"

    def sample(
        self,
        name: str,
        value,
        help_: str,
        labels: dict | None = None,
        type_: str = "gauge",
    ) -> None:
        full = f"{self.prefix}_{name}"
        lines = self._family(full, help_, type_)
        lines.append(f"{full}{self._labels(labels)} {value}")

    def counter(self, name: str, value, help_: str, labels: dict | None = None) -> None:
        self.sample(name, value, help_, labels, type_="counter")

    def gauge(self, name: str, value, help_: str, labels: dict | None = None) -> None:
        self.sample(name, value, help_, labels, type_="gauge")

    def histogram(
        self,
        name: str,
        snapshot: dict,
        help_: str,
        labels: dict | None = None,
    ) -> None:
        """One histogram series from a bus snapshot: ``{"buckets":
        [(le, cumulative_count), ...], "sum": float, "count": int}``
        (``+Inf`` bucket last) — rendered as the ``_bucket``/``_sum``/
        ``_count`` member samples of one declared family."""
        full = f"{self.prefix}_{name}"
        lines = self._family(full, help_, "histogram")
        base = dict(labels or {})
        for le, count in snapshot["buckets"]:
            lines.append(
                f"{full}_bucket"
                f"{self._labels({**base, 'le': _fmt(le)})} {count}"
            )
        lines.append(f"{full}_sum{self._labels(base)} {_fmt(snapshot['sum'])}")
        lines.append(f"{full}_count{self._labels(base)} {snapshot['count']}")

    def render(self) -> str:
        out: list[str] = []
        for full, (help_, type_, lines) in self._families.items():
            out.append(f"# HELP {full} {help_}")
            out.append(f"# TYPE {full} {type_}")
            out.extend(lines)
        return "\n".join(out) + "\n"
