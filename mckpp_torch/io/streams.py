"""Stream-configuration file ingester: the iodef.xml analog (a copy of
``mckpp_tpu/io/streams.py``).

The reference configures its output declaratively in XIOS's iodef.xml
(run/iodef.xml:88-157): a <file_definition> of <file> elements, each with
an output frequency, an optional split frequency, and <field> children
naming a field_ref, an optional output name, and a temporal operation
(instant / average / minimum / maximum).

This module parses that same XML shape (the subset the reference job
actually uses) into :class:`~mckpp_torch.io.diagnostics.Stream` objects, so
an MC-KPP user's output configuration carries over.  XIOS-server tuning
attributes (par_access, type="one_file", iodef <context> machinery) have no
meaning here and are ignored.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from typing import List, Optional

from .diagnostics import Stream, DEPTH_FIELDS, SURFACE_FIELDS

_KNOWN_FIELDS = frozenset(DEPTH_FIELDS + SURFACE_FIELDS)

_DUR_RE = re.compile(r"\s*(\d+(?:\.\d+)?)\s*(ts|s|mn|mi|min|h|d|mo|y)\s*$")
_UNIT_SECONDS = {"s": 1.0, "mn": 60.0, "mi": 60.0, "min": 60.0,
                 "h": 3600.0, "d": 86400.0, "mo": 30.0 * 86400.0,
                 "y": 365.0 * 86400.0}


def duration_to_steps(spec: str, dto_seconds: float) -> int:
    """An XIOS duration ("1h", "3h", "2ts", "30mn", "1d") in ocean steps."""
    m = _DUR_RE.match(spec)
    if not m:
        raise ValueError(f"cannot parse output frequency {spec!r}")
    value, unit = float(m.group(1)), m.group(2)
    if unit == "ts":
        steps = value
    else:
        steps = value * _UNIT_SECONDS[unit] / dto_seconds
    n = max(1, int(round(steps)))
    if abs(steps - n) > 1e-6:
        raise ValueError(
            f"output frequency {spec!r} is not a whole number of ocean "
            f"steps at dto={dto_seconds}s")
    return n


def duration_to_days(spec: str) -> float:
    m = _DUR_RE.match(spec)
    if not m or m.group(2) == "ts":
        raise ValueError(f"cannot parse split frequency {spec!r}")
    return float(m.group(1)) * _UNIT_SECONDS[m.group(2)] / 86400.0


def _truthy(attr: Optional[str], default: bool = True) -> bool:
    if attr is None:
        return default
    return attr.strip().lower().strip(".") in ("true", "t", "1")


_ENTITY_RE = re.compile(r"&(?:[A-Za-z][A-Za-z0-9]*|#[0-9]+|#x[0-9A-Fa-f]+);")


def _sanitize_xml(text: str) -> str:
    """Escape raw ``<`` / ``&`` inside attribute values.

    XIOS's XML layer tolerates markup characters in attribute values — the
    reference's own run/iodef.xml has ``long_name="...(<0 = isothermal
    reset)"`` — but a conforming parser (xml.etree) rejects them.  This
    single pass escapes ``<`` and non-entity ``&`` occurring inside quoted
    attribute values (and skips comments), so the verbatim reference file
    parses.  Well-formed XML passes through unchanged.

    Known limitation: a bare ``<`` or ``&`` in element TEXT content (or
    CDATA) is left untouched and would still fail ET.fromstring, unlike
    XIOS's tolerant parser.  iodef files are attribute-only in practice
    (every reference ``<field>``/``<file>`` element is empty-bodied), so
    only attribute values are scanned.
    """
    out = []
    i, n = 0, len(text)
    in_tag = False
    quote = None                      # the active attribute-value delimiter
    while i < n:
        ch = text[i]
        if quote is not None:
            if ch == quote:
                quote = None
                out.append(ch)
            elif ch == "<":
                out.append("&lt;")
            elif ch == ">":
                out.append("&gt;")
            elif ch == "&" and not _ENTITY_RE.match(text, i):
                out.append("&amp;")
            else:
                out.append(ch)
            i += 1
        elif in_tag:
            if ch in ("'", '"'):
                quote = ch
            elif ch == ">":
                in_tag = False
            out.append(ch)
            i += 1
        elif ch == "<":
            if text.startswith("<!--", i):
                end = text.find("-->", i)
                end = n if end < 0 else end + 3
                out.append(text[i:end])
                i = end
            else:
                in_tag = True
                out.append(ch)
                i += 1
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def parse_iodef(path: str, dto_seconds: float) -> List[Stream]:
    """Parse an iodef.xml-style file into output Streams.

    Each enabled <file> element becomes one Stream; its <field> children
    become (output-name, field_ref, operation) entries, defaulting the
    output name to the field_ref and the operation to "instant" — exactly
    the semantics of the reference job's file_definition
    (run/iodef.xml:88-157).  The raw text is sanitized first (see
    :func:`_sanitize_xml`) so the reference's actual iodef.xml — which
    carries a raw ``<`` inside a long_name attribute (run/iodef.xml:80)
    that XIOS tolerates — ingests verbatim."""
    with open(path, "r") as f:
        root = ET.fromstring(_sanitize_xml(f.read()))
    streams: List[Stream] = []
    for fe in root.iter("file"):
        if not _truthy(fe.get("enabled")):
            continue
        # inherit enabled/split from the enclosing file_definition? XIOS
        # inheritance is deep; the subset here handles the per-file attrs
        # the reference job uses.
        name = fe.get("name") or fe.get("id")
        if name is None:
            raise ValueError("iodef <file> element without name or id")
        freq_attr = fe.get("output_freq")
        if freq_attr is None:
            raise ValueError(f"iodef file {name!r} lacks output_freq")
        freq = duration_to_steps(freq_attr, dto_seconds)
        split = fe.get("split_freq")
        split_days = duration_to_days(split) if split else None
        entries = []
        for fld in fe.iter("field"):
            src = fld.get("field_ref") or fld.get("id")
            if src is None:
                raise ValueError(f"iodef file {name!r}: field without "
                                 "field_ref")
            if src not in _KNOWN_FIELDS:
                raise ValueError(
                    f"iodef file {name!r}: unknown field_ref {src!r} "
                    f"(known diagnostics: {sorted(_KNOWN_FIELDS)})")
            out = fld.get("name") or src
            op = fld.get("operation") or "instant"
            if op not in ("instant", "average", "minimum", "maximum"):
                raise ValueError(f"iodef file {name!r}: unsupported "
                                 f"operation {op!r}")
            entries.append((out, src, op))
        if not entries:
            continue
        ops = {op for _, _, op in entries}
        streams.append(Stream(
            name=name,
            reduction=entries[0][2] if len(ops) == 1 else "mixed",
            freq=freq,
            split_freq_days=split_days,
            entries=tuple(entries)))
    return streams
