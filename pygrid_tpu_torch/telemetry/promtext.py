"""Strict Prometheus text-exposition parser.

The scrape-validity tests run every ``/metrics`` body through this: one
malformed line (duplicate HELP/TYPE, unescaped label value, interleaved
family groups, non-cumulative histogram buckets) fails the whole scrape
in real Prometheus, so it must fail here first. Deliberately stricter
than the wild-west of the ecosystem — this parses OUR output, and our
output has no excuse.

``parse(text)`` returns ``{family_name: Family}`` or raises
:class:`ValueError` with the offending line. The port's copy of
:mod:`pygrid_tpu.telemetry.promtext`.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>\S+)(?: (?P<ts>-?\d+))?$"
)
_TYPES = ("counter", "gauge", "histogram", "summary", "untyped")


@dataclass
class Family:
    name: str
    type: str = "untyped"
    help: str | None = None
    #: [(sample_name, labels_dict, value)]
    samples: list = field(default_factory=list)


def _parse_labels(raw: str, line: str) -> dict:
    """Strict label-set parse with the three escapes the format defines
    (``\\\\``, ``\\"``, ``\\n``); anything else escaped, unterminated, or
    bare is an error."""
    labels: dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        m = re.match(r"[a-zA-Z_][a-zA-Z0-9_]*", raw[i:])
        if m is None:
            raise ValueError(f"bad label name at {raw[i:]!r}: {line!r}")
        name = m.group(0)
        i += len(name)
        if raw[i : i + 2] != '="':
            raise ValueError(f"label {name!r} missing '=\"': {line!r}")
        i += 2
        out = []
        while True:
            if i >= n:
                raise ValueError(f"unterminated label value: {line!r}")
            c = raw[i]
            if c == "\\":
                esc = raw[i + 1 : i + 2]
                if esc == "\\":
                    out.append("\\")
                elif esc == '"':
                    out.append('"')
                elif esc == "n":
                    out.append("\n")
                else:
                    raise ValueError(f"bad escape \\{esc}: {line!r}")
                i += 2
            elif c == '"':
                i += 1
                break
            elif c == "\n":
                raise ValueError(f"raw newline in label value: {line!r}")
            else:
                out.append(c)
                i += 1
        if name in labels:
            raise ValueError(f"duplicate label {name!r}: {line!r}")
        labels[name] = "".join(out)
        if i < n:
            if raw[i] != ",":
                raise ValueError(f"junk after label value: {line!r}")
            i += 1
    return labels


def _parse_value(raw: str, line: str) -> float:
    if raw == "+Inf":
        return math.inf
    if raw == "-Inf":
        return -math.inf
    try:
        return float(raw)
    except ValueError as err:
        raise ValueError(f"bad sample value {raw!r}: {line!r}") from err


def _family_of(sample_name: str, families: dict) -> Family | None:
    """The declared family a sample belongs to: exact name, or the
    ``_bucket``/``_sum``/``_count`` members of a histogram/summary."""
    fam = families.get(sample_name)
    if fam is not None and fam.type not in ("histogram", "summary"):
        return fam
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            fam = families.get(sample_name[: -len(suffix)])
            if fam is not None and fam.type in ("histogram", "summary"):
                if suffix == "_bucket" and fam.type == "summary":
                    return None
                return fam
    return families.get(sample_name)


def parse(text: str) -> dict[str, Family]:
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: dict[str, Family] = {}
    last_family: str | None = None
    seen_series: set[tuple] = set()
    for line in text.split("\n")[:-1]:
        if line == "":
            continue
        if line.startswith("#"):
            parts = line.split(" ", 3)
            if len(parts) < 3 or parts[0] != "#" or parts[1] not in (
                "HELP",
                "TYPE",
            ):
                raise ValueError(f"only HELP/TYPE comments allowed: {line!r}")
            name = parts[2]
            if not _NAME_RE.match(name):
                raise ValueError(f"bad metric name {name!r}: {line!r}")
            fam = families.setdefault(name, Family(name))
            if parts[1] == "HELP":
                if fam.help is not None:
                    raise ValueError(f"duplicate HELP for {name}")
                if fam.samples:
                    raise ValueError(f"HELP after samples for {name}")
                fam.help = parts[3] if len(parts) > 3 else ""
            else:
                if len(parts) < 4 or parts[3] not in _TYPES:
                    raise ValueError(f"bad TYPE: {line!r}")
                if fam.type != "untyped" or fam.samples:
                    raise ValueError(
                        f"duplicate/late TYPE for {name}: {line!r}"
                    )
                fam.type = parts[3]
            last_family = name
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        labels = (
            _parse_labels(m.group("labels"), line)
            if m.group("labels")
            else {}
        )
        value = _parse_value(m.group("value"), line)
        fam = _family_of(m.group("name"), families)
        if fam is None:
            raise ValueError(
                f"sample {m.group('name')!r} has no declared family"
            )
        # family grouping: all of a family's lines must be contiguous
        if fam.name != last_family and fam.samples:
            raise ValueError(
                f"family {fam.name} interleaved with others: {line!r}"
            )
        series = (m.group("name"), tuple(sorted(labels.items())))
        if series in seen_series:
            raise ValueError(f"duplicate series: {line!r}")
        seen_series.add(series)
        fam.samples.append((m.group("name"), labels, value))
        last_family = fam.name
    for fam in families.values():
        if fam.type == "histogram":
            _check_histogram(fam)
    return families


def _check_histogram(fam: Family) -> None:
    """Per label-set (excluding ``le``): buckets must be cumulative and
    non-decreasing, carry a ``+Inf`` bucket, and agree with ``_count``."""
    groups: dict[tuple, dict] = {}
    for name, labels, value in fam.samples:
        if name == f"{fam.name}_bucket":
            if "le" not in labels:
                raise ValueError(f"{fam.name} bucket missing le label")
            rest = tuple(
                sorted((k, v) for k, v in labels.items() if k != "le")
            )
            g = groups.setdefault(rest, {"buckets": [], "count": None})
            le = _parse_value(labels["le"], f"le={labels['le']}")
            g["buckets"].append((le, value))
        elif name == f"{fam.name}_count":
            rest = tuple(sorted(labels.items()))
            g = groups.setdefault(rest, {"buckets": [], "count": None})
            g["count"] = value
    for rest, g in groups.items():
        buckets = sorted(g["buckets"])
        if not buckets or not math.isinf(buckets[-1][0]):
            raise ValueError(f"{fam.name}{dict(rest)} missing +Inf bucket")
        prev = -math.inf
        for _, c in buckets:
            if c < prev:
                raise ValueError(
                    f"{fam.name}{dict(rest)} buckets not cumulative"
                )
            prev = c
        if g["count"] is not None and buckets[-1][1] != g["count"]:
            raise ValueError(
                f"{fam.name}{dict(rest)} +Inf bucket != _count"
            )
