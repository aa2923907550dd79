"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (``configs/<config>.json``, the file the entry names), its
traffic mix (``traffic/<traffic>.json``), each metric's reader
(``metrics/<metric>.py``) and each configuration's correctness limits
(``limits/<config>.json``, with ``limits/<config>.<traffic>.json`` for a
mix's own numbers where it has some) and each cell's window
(``cells/<cell>.json``).  A later change adds a configuration, a mix, a
cell or a metric by adding such files and entries; nothing here names
one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    """One workload entry with what it resolves to."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict
    steps_per_s: float     # the window's fixed rate (cells/<cell>.json)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def bench_dir(root: str) -> str:
    return os.path.join(root, "kppbench")


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics that cell
    ``workload`` reports: those without a ``workloads`` key, and those
    whose key lists it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def resolve(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``root``'s BENCHMARK.json with its
    configuration, traffic mix and limits read from their files."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; one of {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    bdir = bench_dir(root)
    config = _json(os.path.join(root, entry["file"]))
    traffic = _json(os.path.join(bdir, "traffic", w["traffic"] + ".json"))
    limits = _json(os.path.join(bdir, "limits", w["config"] + ".json"))
    extra = os.path.join(bdir, "limits",
                         f"{w['config']}.{w['traffic']}.json")
    if os.path.exists(extra):
        limits.update(_json(extra))
    window = _json(os.path.join(bdir, "cells", workload + ".json"))
    return Cell(name=workload, config=config, traffic=traffic,
                chips=w["chips"], steps_per_s=float(window["steps_per_s"]),
                end_to_end=metrics_of(bench, workload, "end_to_end"),
                per_layer=metrics_of(bench, workload, "per_layer"),
                limits=limits)


def reader(metric: str, root: str = ROOT):
    """The ``read(run)`` function of ``metrics/<metric>.py`` (loaded by
    path: a metric's name may hold dots)."""
    path = os.path.join(bench_dir(root), "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "kppbench_metric_" + re.sub(r"\W", "_", metric), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict) -> list:
    """What in ``bench`` breaks the naming rules of the benchmark's
    contract (names, units, sources, the keys of each entry); empty when
    nothing does."""
    out = []

    def name(kind, v):
        if not isinstance(v, str) or not NAME_RE.match(v):
            out.append(f"{kind} {v!r}: not a name")

    for c in bench["configs"]:
        name("config", c["name"])
        for k in c["reduced"]:
            name("reduced key", k)
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']}: keys {sorted(c)}")
    for w in bench["workloads"]:
        for k in ("name", "config", "traffic"):
            name(f"workload {k}", w[k])
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips {w['chips']}")
        if len(w["why"]) > 200:
            out.append(f"workload {w['name']}: why over 200 characters")
    seen = set()
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            name("metric", m["name"])
            if m["name"] in seen:
                out.append(f"metric {m['name']} twice")
            seen.add(m["name"])
            if not UNIT_RE.match(m["unit"]):
                out.append(f"metric {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                out.append(f"metric {m['name']}: source {m['source']!r}")
    return out
