"""CLI validator for exported obs artifacts (port of
``repro.obs.validate``).

    python -m repro_torch.obs.validate [--trace trace.json]
        [--metrics metrics.json] [--prom metrics.prom] [--expect-spec]
        [--expect-prefix-cache]

Checks, exiting nonzero on any failure:

  * **schema** - the Chrome trace and the metrics JSON validate against
    the checked-in ``schemas/*.schema.json`` (the reference's, copied);
  * **span semantics** - per-lane B/E events balance (every span that
    opens closes, no cross-nesting), timestamps are non-decreasing, and
    the required lifecycle spans all occur: ``request``, ``queue``,
    ``prefill``, ``decode``, ``engine.decode_step`` and the
    ``first_token`` instant; plus ``spec.draft`` and ``spec.verify``
    under ``--expect-spec``, and ``cache_lookup`` (with the prefix-cache
    and preemption counters on the metrics side) under
    ``--expect-prefix-cache``;
  * **instruments** - labeled series are lists of cells in sorted label
    order with no duplicate label sets; the numerics section's chart
    series are ``[step, value]`` pairs with non-decreasing steps and its
    per-layer stats are numbers;
  * **prometheus** - every non-comment line of the ``.prom`` text parses
    as ``name[{labels}] value``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys

from .schema import load_schema, validate

REQUIRED_SPANS = ("request", "queue", "prefill", "decode",
                  "engine.decode_step")
SPEC_SPANS = ("spec.draft", "spec.verify")
# with --expect-prefix-cache: every admission probes the cache, so the
# lookup span must occur; preemption only happens under pool pressure, so
# its presence is asserted on the METRICS side (counters exist at zero)
CACHE_SPANS = ("cache_lookup",)
CACHE_COUNTERS = ("prefix_cache_hit_total", "prefix_cache_miss_total",
                  "prefix_cache_evict_total", "serve_preempt_total",
                  "serve_requeue_total")

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? (-?[0-9.eE+-]+|NaN|[+-]Inf)$")


def check_trace(doc: dict, expect_spec: bool = False,
                expect_cache: bool = False) -> list:
    """Schema + span-semantics errors for a Chrome-trace document."""
    errs = validate(doc, load_schema("trace"))
    if errs:
        return errs
    stacks: dict[int, list] = {}
    last_ts = None
    seen = set()
    for i, ev in enumerate(doc["traceEvents"]):
        ph, name, tid = ev["ph"], ev["name"], ev["tid"]
        if ph == "M":
            continue
        seen.add(name)
        if last_ts is not None and ev["ts"] < last_ts:
            errs.append(f"event {i} ({name}): ts {ev['ts']} < previous "
                        f"{last_ts} (events must be emitted in order)")
        last_ts = ev["ts"]
        if ph == "B":
            stacks.setdefault(tid, []).append(name)
        elif ph == "E":
            stack = stacks.setdefault(tid, [])
            if not stack:
                errs.append(f"event {i}: E {name!r} on tid {tid} "
                            "with no open span")
            elif stack[-1] != name:
                errs.append(f"event {i}: E {name!r} on tid {tid} but "
                            f"innermost open span is {stack[-1]!r} "
                            "(spans must nest)")
                stack.pop()
            else:
                stack.pop()
    for tid, stack in sorted(stacks.items()):
        if stack:
            errs.append(f"tid {tid}: unclosed span(s) {stack!r}")
    want = REQUIRED_SPANS + (SPEC_SPANS if expect_spec else ()) \
        + (CACHE_SPANS if expect_cache else ())
    for name in want:
        if name not in seen:
            errs.append(f"required span {name!r} never occurs")
    if "first_token" not in seen:
        errs.append("required instant 'first_token' never occurs")
    return errs


def check_metrics(doc: dict, expect_spec: bool = False,
                  expect_cache: bool = False) -> list:
    """Schema, expectation, instrument-grammar and numerics errors of a
    snapshot."""
    errs = validate(doc, load_schema("metrics"))
    if errs:
        return errs
    if expect_spec and not doc["speculative"]["enabled"]:
        errs.append("$.speculative.enabled: expected true (--expect-spec)")
    if expect_cache:
        for name in CACHE_COUNTERS:
            if name not in doc.get("metrics", {}):
                errs.append(f"$.metrics.{name}: required counter missing "
                            "(--expect-prefix-cache)")
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
    ap.add_argument("--trace", help="Chrome-trace JSON to validate")
    ap.add_argument("--metrics", help="metrics snapshot JSON to validate")
    ap.add_argument("--prom", help="Prometheus text file to validate")
    ap.add_argument("--expect-spec", action="store_true",
                    help="require speculative spans + enabled flag")
    ap.add_argument("--expect-prefix-cache", action="store_true",
                    help="require the cache_lookup span and the prefix-"
                    "cache / preemption counters")
    args = ap.parse_args(argv)
    if not (args.trace or args.metrics or args.prom):
        ap.error("nothing to validate: pass --trace / --metrics / --prom")

    failures = 0
    for label, path, check in (
            ("trace", args.trace,
             lambda d: check_trace(d, args.expect_spec,
                                   args.expect_prefix_cache)),
            ("metrics", args.metrics,
             lambda d: check_metrics(d, args.expect_spec,
                                     args.expect_prefix_cache))):
        if not path:
            continue
        with open(path) as f:
            doc = json.load(f)
        errs = check(doc)
        for e in errs:
            print(f"[obs.validate] {label} {path}: {e}")
        failures += len(errs)
        if not errs:
            n = len(doc["traceEvents"]) if label == "trace" else \
                len(doc["metrics"])
            print(f"[obs.validate] {label} {path}: OK ({n} "
                  f"{'events' if label == 'trace' else 'instruments'})")
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
