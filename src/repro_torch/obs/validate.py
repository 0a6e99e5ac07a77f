"""CLI validator for exported obs artifacts, metrics half (port of
``repro.obs.validate``).

    python -m repro_torch.obs.validate --metrics metrics.json
        [--prom metrics.prom]

Checks, exiting nonzero on any failure:

  * **schema** - the metrics JSON validates against the checked-in
    ``schemas/metrics.schema.json`` (the reference's, copied);
  * **instruments** - labeled series are lists of cells in sorted label
    order with no duplicate label sets; the numerics section's chart
    series are ``[step, value]`` pairs with non-decreasing steps and its
    per-layer stats are numbers;
  * **prometheus** - every non-comment line of the ``.prom`` text parses
    as ``name[{labels}] value``.

The trace checks (``--trace``) and the serving snapshot's expectations
(``--expect-spec``, ``--expect-prefix-cache``) come with the
serving-telemetry slice.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

from .schema import load_schema, validate

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.eE+-]+|NaN|[+-]Inf)$")


def check_metrics(doc: dict) -> list:
    """Schema, instrument-grammar and numerics errors of a snapshot."""
    errs = validate(doc, load_schema("metrics"))
    if errs:
        return errs
    errs.extend(_check_instruments(doc.get("metrics", {})))
    if "numerics" in doc:
        errs.extend(_check_numerics(doc["numerics"]))
    return errs


_INSTRUMENT_KINDS = ("counter", "gauge", "histogram")


def _check_instruments(metrics: dict) -> list:
    """Grammar over instrument snapshots, incl. labeled series.

    Unlabeled counters/gauges carry ``value`` (histograms ``count``);
    labeled instruments instead carry ``labels``: a list of cells, each
    with a string-valued ``labels`` object plus the same payload — in
    stable sorted label order with no duplicate label sets (the
    per-layer export contract)."""
    errs = []
    for name, inst in sorted(metrics.items()):
        p = f"$.metrics.{name}"
        if not isinstance(inst, dict) or inst.get("kind") \
                not in _INSTRUMENT_KINDS:
            errs.append(f"{p}: not an instrument snapshot")
            continue
        payload = ("value" if inst["kind"] in ("counter", "gauge")
                   else "count")
        if "labels" not in inst:
            if payload not in inst:
                errs.append(f"{p}: {inst['kind']} missing {payload!r}")
            continue
        if not isinstance(inst["labels"], list):
            errs.append(f"{p}.labels: expected a list of labeled cells")
            continue
        keys = []
        for i, cell in enumerate(inst["labels"]):
            cp = f"{p}.labels[{i}]"
            if not isinstance(cell, dict) \
                    or not isinstance(cell.get("labels"), dict):
                errs.append(f"{cp}: labeled cell needs a 'labels' object")
                continue
            if not all(isinstance(v, str) for v in cell["labels"].values()):
                errs.append(f"{cp}: label values must be strings")
            if payload not in cell:
                errs.append(f"{cp}: {inst['kind']} cell missing {payload!r}")
            keys.append(tuple(cell["labels"].values()))
        if keys != sorted(keys):
            errs.append(f"{p}.labels: cells not in sorted label order")
        if len(set(keys)) != len(keys):
            errs.append(f"{p}.labels: duplicate label sets")
    return errs


def _check_numerics(num) -> list:
    """Semantic checks the JSON-schema subset can't express: chart
    series are [step, value] pairs with non-decreasing steps, per-layer
    stats are flat numeric dicts."""
    errs = []
    for name, pts in sorted((num.get("series") or {}).items()):
        sp = f"$.numerics.series.{name}"
        if not isinstance(pts, list) or any(
                not (isinstance(pt, list) and len(pt) == 2
                     and isinstance(pt[0], int)
                     and isinstance(pt[1], (int, float))
                     and not isinstance(pt[1], bool))
                for pt in pts):
            errs.append(f"{sp}: expected a list of [step, value] pairs")
            continue
        steps = [pt[0] for pt in pts]
        if steps != sorted(steps):
            errs.append(f"{sp}: steps must be non-decreasing")
    for site, stats in sorted((num.get("per_layer") or {}).items()):
        if not isinstance(stats, dict) or not all(
                v is None or (isinstance(v, (int, float))
                              and not isinstance(v, bool))
                for v in stats.values()):
            errs.append(f"$.numerics.per_layer.{site}: stats must be "
                        "numbers (or null)")
    return errs


def check_prometheus(text: str) -> list:
    errs = []
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        return ["prometheus text is empty"]
    for i, ln in enumerate(lines):
        if ln.startswith("#"):
            continue
        if not _PROM_LINE.match(ln):
            errs.append(f"prom line {i}: unparseable: {ln!r}")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.obs.validate")
    ap.add_argument("--metrics", help="metrics snapshot JSON to validate")
    ap.add_argument("--prom", help="Prometheus text file to validate")
    args = ap.parse_args(argv)
    if not (args.metrics or args.prom):
        ap.error("nothing to validate: pass --metrics / --prom")

    failures = 0
    if args.metrics:
        with open(args.metrics) as f:
            doc = json.load(f)
        errs = check_metrics(doc)
        for e in errs:
            print(f"[obs.validate] metrics {args.metrics}: {e}")
        failures += len(errs)
        if not errs:
            print(f"[obs.validate] metrics {args.metrics}: OK "
                  f"({len(doc['metrics'])} instruments)")
    if args.prom:
        with open(args.prom) as f:
            errs = check_prometheus(f.read())
        for e in errs:
            print(f"[obs.validate] prom {args.prom}: {e}")
        failures += len(errs)
        if not errs:
            print(f"[obs.validate] prom {args.prom}: OK")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
