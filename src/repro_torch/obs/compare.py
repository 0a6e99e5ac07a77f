"""Snapshot differ for the numerics observability plane (port of
``repro.obs.compare``).

Compares the ``numerics`` sections of two ``repro.obs.metrics/v1``
snapshots (a QAD training export, a serving export, or one of each —
they share the schema) and prints the top-k drifted layers.  With
``--gate`` it exits nonzero when drift exceeds the thresholds — the CI
``numerics-drift`` job's golden-envelope canary: a clean-vs-clean diff
must pass, a clean-vs-noise-injected diff must fail.

    python -m repro_torch.obs.compare baseline.json candidate.json \
        [--top-k 10] [--gate] [--max-sqnr-drop-db 1.0] \
        [--max-kl-increase 0.05] [--max-cos-drop 0.02]

Severity ordering: a layer's drift score is the max over its per-stat
normalized drifts, so a layer that regressed on any one axis (SQNR
down, KL up, cosine down, clip fraction up) sorts to the top.
"""
from __future__ import annotations

import argparse
import json
import sys

SCHEMA = "repro.obs.metrics/v1"

# stat -> (direction, gate_arg); direction +1 = higher is worse
_DRIFT_STATS = {
    "sqnr_db": (-1, "max_sqnr_drop_db"),
    "hidden_cos": (-1, "max_cos_drop"),
    "top1_agree": (-1, None),
    "kl": (+1, "max_kl_increase"),
    "hidden_mse": (+1, None),
    "clip_frac": (+1, None),
    "amax": (+1, "max_amax_rel"),     # relative drift, see _drift()
}


def load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise SystemExit(f"{path}: schema {doc.get('schema')!r}, "
                         f"expected {SCHEMA!r}")
    return doc


def per_layer(snap: dict) -> dict:
    """``site -> {stat: value}`` from a snapshot's numerics section."""
    return (snap.get("numerics") or {}).get("per_layer") or {}


def _drift(stat: str, base: float, cand: float):
    """Signed 'badness' of candidate vs baseline for this stat.

    Positive = regressed.  ``amax`` drifts are relative (|Δ|/|base|)
    because its natural scale varies per layer; everything else is an
    absolute delta in the stat's own units, signed by direction.
    """
    sign, _ = _DRIFT_STATS[stat]
    if stat == "amax":
        denom = max(abs(base), 1e-12)
        return abs(cand - base) / denom
    return sign * (cand - base)


def diff(base: dict, cand: dict) -> list:
    """Rows ``(site, stat, base, cand, badness)`` over the shared sites."""
    rows = []
    b_layers, c_layers = per_layer(base), per_layer(cand)
    for site in sorted(set(b_layers) & set(c_layers)):
        bs, cs = b_layers[site], c_layers[site]
        for stat in sorted(set(bs) & set(cs)):
            if stat not in _DRIFT_STATS:
                continue
            bv, cv = bs[stat], cs[stat]
            if bv is None or cv is None:
                continue
            rows.append((site, stat, bv, cv, _drift(stat, bv, cv)))
    rows.sort(key=lambda r: -r[4])
    return rows


def _series_mean(snap: dict, name: str):
    pts = ((snap.get("numerics") or {}).get("series") or {}).get(name) or []
    vals = [v for _, v in pts]
    return (sum(vals) / len(vals)) if vals else None


def gate_violations(base: dict, cand: dict, thresholds: dict) -> list:
    """Threshold checks for --gate; returns human-readable violations."""
    out = []
    for site, stat, bv, cv, bad in diff(base, cand):
        _, arg = _DRIFT_STATS[stat]
        limit = thresholds.get(arg) if arg else None
        if limit is not None and bad > limit:
            out.append(f"{site} {stat}: {bv:.4g} -> {cv:.4g} "
                       f"(drift {bad:.4g} > {limit:g})")
    b_kl, c_kl = (_series_mean(base, "qad_live_kl"),
                  _series_mean(cand, "qad_live_kl"))
    lim = thresholds.get("max_kl_increase")
    if b_kl is not None and c_kl is not None and lim is not None:
        if c_kl - b_kl > lim:
            out.append(f"qad_live_kl mean: {b_kl:.4g} -> {c_kl:.4g} "
                       f"(increase {c_kl - b_kl:.4g} > {lim:g})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.compare",
        description="diff the numerics sections of two repro.obs.metrics/v1 "
                    "snapshots; --gate turns thresholds into an exit code")
    ap.add_argument("baseline")
    ap.add_argument("candidate")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 when any drift threshold is exceeded")
    ap.add_argument("--max-sqnr-drop-db", type=float, default=1.0)
    ap.add_argument("--max-kl-increase", type=float, default=0.05)
    ap.add_argument("--max-cos-drop", type=float, default=0.02)
    ap.add_argument("--max-amax-rel", type=float, default=0.1)
    args = ap.parse_args(argv)

    base, cand = load(args.baseline), load(args.candidate)
    rows = diff(base, cand)
    if not rows:
        print("numerics: no shared per-layer probes between the snapshots")
    else:
        print(f"top {min(args.top_k, len(rows))} drifted layer stats "
              f"({args.baseline} -> {args.candidate}):")
        print(f"  {'site':<32} {'stat':<12} {'base':>12} {'cand':>12} "
              f"{'drift':>10}")
        for site, stat, bv, cv, bad in rows[: args.top_k]:
            print(f"  {site:<32} {stat:<12} {bv:>12.4g} {cv:>12.4g} "
                  f"{bad:>10.4g}")
    for name in ("qad_live_kl", "spec_accept_rate"):
        b, c = _series_mean(base, name), _series_mean(cand, name)
        if b is not None or c is not None:
            fmt = lambda v: "n/a" if v is None else f"{v:.4g}"
            print(f"  series {name}: mean {fmt(b)} -> {fmt(c)}")

    if args.gate:
        thresholds = {"max_sqnr_drop_db": args.max_sqnr_drop_db,
                      "max_kl_increase": args.max_kl_increase,
                      "max_cos_drop": args.max_cos_drop,
                      "max_amax_rel": args.max_amax_rel}
        violations = gate_violations(base, cand, thresholds)
        if violations:
            print("GATE FAIL:", file=sys.stderr)
            for v in violations:
                print(f"  {v}", file=sys.stderr)
            return 1
        print("gate: OK (all drifts within thresholds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
