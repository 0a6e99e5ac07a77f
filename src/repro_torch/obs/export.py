"""Snapshot exporter: one schema over Engine/SpecEngine stats, training
runs and their metrics (port of ``repro.obs.export``).

``metrics_snapshot(engine)`` reshapes the engine's flat ``stats()`` dict
and its live registry into the ``repro.obs.metrics/v1`` document that
``schemas/metrics.schema.json`` validates: engine identity, throughput,
latency percentiles (``None`` = no data, never 0.0), a speculative
section that exists for BOTH engine kinds (``enabled: false`` with null
rates on the plain engine), the state backend's own stats, the raw
instrument snapshot and, with the shadow teacher on, the numerics
section.  ``write_metrics`` writes the JSON document plus a sibling
``.prom`` file in Prometheus text exposition format (derived engine
gauges + every registry instrument); ``write_trace`` writes the tracer's
Chrome-trace JSON (open at ui.perfetto.dev).

``training_snapshot`` is the same document for a QAD training run:
``engine.kind`` is ``"train"`` and the serving-only sections carry their
explicit "no data" shapes (null latencies, ``speculative.enabled:
false``); ``write_training_metrics`` writes it and its ``.prom`` file.
"""
from __future__ import annotations

import json

SCHEMA = "repro.obs.metrics/v1"

_LATENCY_KEYS = ("ttft_p50_s", "ttft_p95_s",
                 "decode_lat_p50_s", "decode_lat_p95_s")


def metrics_snapshot(engine) -> dict:
    """The unified ``repro.obs.metrics/v1`` document for an engine."""
    st = engine.stats()
    spec = bool(st.get("speculative"))
    return {
        "schema": SCHEMA,
        "engine": {
            "kind": "spec" if spec else "engine",
            "steps": int(st["steps"]),
            "decode_steps": int(st["decode_steps"]),
            "requests_finished": int(st["requests_finished"]),
            "fused_kernels": "on" if st["fused_kernels"] else "off",
            "packed_backend": str(st["packed_backend"]),
        },
        "throughput": {
            "tokens_generated": int(st["tokens_generated"]),
            "prefill_tokens": int(st["prefill_tokens"]),
            "prefill_s": st["prefill_s"],
            "decode_s": st["decode_s"],
            "decode_tok_s": st["decode_tok_s"],
            "e2e_tok_s": st["e2e_tok_s"],
        },
        "latency": {k: st[k] for k in _LATENCY_KEYS},
        "speculative": {
            "enabled": spec,
            "acceptance_rate": st.get("acceptance_rate"),
            "accepted_per_step": st.get("accepted_per_step"),
            "drafted_tokens": int(st.get("drafted_tokens", 0)),
            "accepted_tokens": int(st.get("accepted_tokens", 0)),
            "rolled_back_tokens": int(st.get("rolled_back_tokens", 0)),
            "draft_mode": st.get("draft_mode"),
            "spec_k": st.get("spec_k"),
        },
        "state": engine.state.stats(),
        "metrics": engine.obs.metrics.snapshot(),
        **_numerics_section(getattr(engine, "numerics", None)),
    }


def _numerics_section(recorder) -> dict:
    """Optional ``numerics`` key from a NumericsRecorder (or nothing)."""
    if recorder is None:
        return {}
    return {"numerics": recorder.summary()}


def training_snapshot(step: int, registry, *, recorder=None,
                      tokens: int = 0, evals: dict | None = None) -> dict:
    """A ``repro.obs.metrics/v1`` document for a QAD training run."""
    return {
        "schema": SCHEMA,
        "engine": {
            "kind": "train",
            "steps": int(step),
            "decode_steps": 0,
            "requests_finished": 0,
            "fused_kernels": "off",
            "packed_backend": "n/a",
        },
        "throughput": {
            "tokens_generated": int(tokens),
            "prefill_tokens": 0,
            "prefill_s": 0.0,
            "decode_s": 0.0,
            "decode_tok_s": None,
            "e2e_tok_s": None,
        },
        "latency": {k: None for k in _LATENCY_KEYS},
        "speculative": {
            "enabled": False,
            "acceptance_rate": None,
            "accepted_per_step": None,
            "drafted_tokens": 0,
            "accepted_tokens": 0,
            "rolled_back_tokens": 0,
            "draft_mode": None,
            "spec_k": None,
        },
        "state": dict(evals or {}),
        "metrics": registry.snapshot(),
        **_numerics_section(recorder),
    }


def prom_path(path: str) -> str:
    """The ``.prom`` sibling of a snapshot path (``m.json`` -> ``m.prom``)."""
    return path.rsplit(".", 1)[0] + ".prom" if "." in path else path + ".prom"


def write_training_metrics(path: str, step: int, registry, *, recorder=None,
                           tokens: int = 0, evals: dict | None = None) -> dict:
    """Write a training snapshot to ``path`` (+ sibling ``.prom``)."""
    snap = training_snapshot(step, registry, recorder=recorder,
                             tokens=tokens, evals=evals)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2)
    with open(prom_path(path), "w") as f:
        f.write(registry.to_prometheus())
    return snap


def _prom_value(v) -> str:
    return "NaN" if v is None else f"{v:g}"


def to_prometheus(snap: dict, registry) -> str:
    """Prometheus text: derived engine gauges + every registry instrument."""
    e, t, lat = snap["engine"], snap["throughput"], snap["latency"]
    sp = snap["speculative"]
    lines = []
    for name, val, help in (
        ("serve_engine_steps", e["steps"], "engine scheduling rounds"),
        ("serve_engine_decode_steps", e["decode_steps"],
         "batched decode steps"),
        ("serve_engine_requests_finished", e["requests_finished"],
         "retired requests"),
        ("serve_decode_tok_s", t["decode_tok_s"],
         "decode-loop throughput, tokens/s"),
        ("serve_e2e_tok_s", t["e2e_tok_s"],
         "end-to-end throughput, tokens/s"),
        ("serve_ttft_p50_seconds", lat["ttft_p50_s"],
         "median submit-to-first-token latency (NaN = no data)"),
        ("serve_ttft_p95_seconds", lat["ttft_p95_s"],
         "p95 submit-to-first-token latency (NaN = no data)"),
        ("serve_decode_lat_p50_seconds", lat["decode_lat_p50_s"],
         "median per-token decode latency (NaN = no data)"),
        ("serve_decode_lat_p95_seconds", lat["decode_lat_p95_s"],
         "p95 per-token decode latency (NaN = no data)"),
        ("spec_acceptance_rate", sp["acceptance_rate"],
         "speculative acceptance = live QAD KL-closeness eval "
         "(NaN = not speculative / nothing drafted)"),
        ("spec_accepted_per_step", sp["accepted_per_step"],
         "tokens emitted per verify round (NaN = not speculative)"),
    ):
        lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_prom_value(val)}")
    text = "\n".join(lines) + "\n"
    return text + registry.to_prometheus()


def write_metrics(engine, path: str) -> dict:
    """Write the JSON snapshot to ``path`` and the Prometheus text to its
    ``.prom`` sibling; returns the snapshot."""
    snap = metrics_snapshot(engine)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2)
    with open(prom_path(path), "w") as f:
        f.write(to_prometheus(snap, engine.obs.metrics))
    return snap


def write_trace(engine, path: str) -> None:
    """Write the engine tracer's Chrome-trace JSON to ``path``."""
    engine.obs.trace.write(path)
