"""Zero-dependency metrics registry: counters, gauges, bounded histograms
(port of ``repro.obs.metrics``: plain Python, the same instruments,
snapshots and Prometheus text).

Design rules (these are what make the registry serve-hot-path safe):

  * **Handles are created once.**  Instruments (and their label children)
    are resolved at engine construction; the hot path is ``handle.inc()`` /
    ``handle.observe(v)`` — a single bound-method call, no name lookup and
    no per-call label-dict churn.
  * **A disabled registry is a TRUE no-op.**  Every factory on the
    ``NOOP_REGISTRY`` returns the same shared ``NOOP_INSTRUMENT`` singleton
    and registers nothing, so an engine built without observability
    allocates zero metric objects and its decode path executes only no-op
    method calls.
  * **Histograms are bounded.**  Each keeps exact count / sum / min / max
    plus a fixed-capacity uniform reservoir (Vitter's algorithm R with a
    deterministic 64-bit LCG — reproducible, no ``random`` import), so
    percentiles stay available at O(1) memory no matter how many tokens a
    long-lived engine serves.

Percentile accessors return ``None`` — never ``0.0`` — when no sample has
been observed, so "no data" can never be mistaken for "zero latency".
"""
from __future__ import annotations

_MASK64 = (1 << 64) - 1


def _percentile(sorted_vals, q: float):
    """Linear-interpolated percentile of a sorted list (numpy 'linear')."""
    n = len(sorted_vals)
    if n == 0:
        return None
    pos = (n - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


def _escape_label(v) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _fmt_labels(names, values) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _CounterChild:
    """One labeled counter cell — the hot-path handle."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Counter:
    """Monotonically increasing count, optionally labeled.

    Unlabeled: ``c.inc()``.  Labeled: bind a child once with
    ``c.labels(backend="pallas_2d")`` and ``inc()`` the child.
    """

    kind = "counter"
    __slots__ = ("name", "help", "label_names", "value", "_children")

    def __init__(self, name: str, help: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.value = 0.0
        self._children: dict[tuple, _CounterChild] = {}

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def labels(self, **kv) -> _CounterChild:
        key = tuple(kv[n] for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _CounterChild()
        return child

    def snapshot(self) -> dict:
        d = {"kind": self.kind, "help": self.help}
        if self.label_names:
            d["labels"] = [
                {"labels": dict(zip(self.label_names, key)), "value": c.value}
                for key, c in sorted(self._children.items())]
        else:
            d["value"] = self.value
        return d

    def prometheus(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} counter"]
        if self.label_names:
            for key, c in sorted(self._children.items()):
                lines.append(f"{self.name}"
                             f"{_fmt_labels(self.label_names, key)}"
                             f" {c.value:g}")
        else:
            lines.append(f"{self.name} {self.value:g}")
        return lines


class _GaugeChild:
    """One labeled gauge cell — the hot-path handle."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value, optionally labeled.

    Labeled gauges (``labels=("layer",)``) mirror labeled counters: bind
    a child once with ``g.labels(layer="mlp.act")`` and ``set()`` the
    child.  Children export sorted by label key, so per-layer series
    keep a stable order in both JSON and Prometheus text.
    """

    kind = "gauge"
    __slots__ = ("name", "help", "label_names", "value", "_children")

    def __init__(self, name: str, help: str = "", label_names: tuple = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self.value = 0.0
        self._children: dict[tuple, _GaugeChild] = {}

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def labels(self, **kv) -> _GaugeChild:
        key = tuple(kv[n] for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = _GaugeChild()
        return child

    def snapshot(self) -> dict:
        d = {"kind": self.kind, "help": self.help}
        if self.label_names:
            d["labels"] = [
                {"labels": dict(zip(self.label_names, key)), "value": c.value}
                for key, c in sorted(self._children.items())]
        else:
            d["value"] = self.value
        return d

    def prometheus(self) -> list:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} gauge"]
        if self.label_names:
            for key, c in sorted(self._children.items()):
                lines.append(f"{self.name}"
                             f"{_fmt_labels(self.label_names, key)}"
                             f" {c.value:g}")
        else:
            lines.append(f"{self.name} {self.value:g}")
        return lines


class Histogram:
    """Bounded-reservoir histogram: exact count/sum/min/max, sampled
    percentiles over at most ``cap`` retained values."""

    kind = "histogram"
    QUANTILES = (50.0, 90.0, 95.0, 99.0)
    __slots__ = ("name", "help", "cap", "count", "sum", "min", "max",
                 "reservoir", "_rng", "label_names", "_children")

    def __init__(self, name: str, help: str = "", cap: int = 512,
                 label_names: tuple = ()):
        if cap < 1:
            raise ValueError(f"histogram cap must be >= 1, got {cap}")
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._children: dict[tuple, "Histogram"] = {}
        self.cap = int(cap)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.reservoir: list[float] = []
        # deterministic per-name seed -> reproducible reservoirs in tests
        seed = 0x9E3779B97F4A7C15
        for ch in name:
            seed = ((seed ^ ord(ch)) * 0x100000001B3) & _MASK64
        self._rng = seed or 1

    def _rand(self) -> int:
        self._rng = (self._rng * 6364136223846793005
                     + 1442695040888963407) & _MASK64
        return self._rng >> 16

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self.reservoir) < self.cap:
            self.reservoir.append(v)
        else:                       # algorithm R: keep with prob cap/count
            j = self._rand() % self.count
            if j < self.cap:
                self.reservoir[j] = v

    def percentile(self, q: float):
        """q-th percentile of the reservoir, or None with no samples."""
        return _percentile(sorted(self.reservoir), q)

    def labels(self, **kv) -> "Histogram":
        """Bind (once) a labeled child histogram — a full reservoir per
        label set.  The child's name embeds the label key so its
        deterministic reservoir seed differs per child."""
        key = tuple(kv[n] for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = Histogram(
                self.name + "{" + ",".join(map(str, key)) + "}",
                self.help, self.cap)
        return child

    def _stats(self) -> dict:
        s = sorted(self.reservoir)
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max,
                **{f"p{q:g}": _percentile(s, q) for q in self.QUANTILES}}

    def snapshot(self) -> dict:
        d = {"kind": self.kind, "help": self.help}
        if self.label_names:
            d["labels"] = [
                {"labels": dict(zip(self.label_names, key)), **c._stats()}
                for key, c in sorted(self._children.items())]
            return d
        return {**d, **self._stats()}

    def prometheus(self) -> list:
        # exported summary-style: quantiles + _sum/_count
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} summary"]
        if self.label_names:
            for key, c in sorted(self._children.items()):
                s = sorted(c.reservoir)
                for q in self.QUANTILES:
                    v = _percentile(s, q)
                    if v is not None:
                        lines.append(
                            f"{self.name}"
                            f"{_fmt_labels((*self.label_names, 'quantile'), (*key, f'{q / 100.0:g}'))}"
                            f" {v:g}")
                lbl = _fmt_labels(self.label_names, key)
                lines.append(f"{self.name}_sum{lbl} {c.sum:g}")
                lines.append(f"{self.name}_count{lbl} {c.count}")
            return lines
        s = sorted(self.reservoir)
        for q in self.QUANTILES:
            v = _percentile(s, q)
            if v is not None:
                lines.append(f'{self.name}{{quantile="{q / 100.0:g}"}} {v:g}')
        lines.append(f"{self.name}_sum {self.sum:g}")
        lines.append(f"{self.name}_count {self.count}")
        return lines


class MetricsRegistry:
    """Name -> instrument registry with Prometheus + JSON export."""

    enabled = True

    def __init__(self):
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, factory, kind: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = factory()
        elif m.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{m.kind}, not {kind}")
        return m

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> Counter:
        return self._get(name, lambda: Counter(name, help, labels), "counter")

    def gauge(self, name: str, help: str = "", labels: tuple = ()) -> Gauge:
        return self._get(name, lambda: Gauge(name, help, labels), "gauge")

    def histogram(self, name: str, help: str = "", cap: int = 512,
                  labels: tuple = ()) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, cap, labels),
                         "histogram")

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        return {name: m.snapshot()
                for name, m in sorted(self._metrics.items())}

    def to_prometheus(self) -> str:
        lines = []
        for _, m in sorted(self._metrics.items()):
            lines.extend(m.prometheus())
        return "\n".join(lines) + ("\n" if lines else "")


class _NoopInstrument:
    """Shared do-nothing counter/gauge/histogram."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def labels(self, **kv) -> "_NoopInstrument":
        return self

    def percentile(self, q: float):
        return None


NOOP_INSTRUMENT = _NoopInstrument()


class NoopRegistry:
    """Disabled registry: registers nothing, hands out the shared no-op
    instrument for every name.  ``snapshot()`` is always empty."""

    enabled = False

    def counter(self, name: str, help: str = "", labels: tuple = ()):
        return NOOP_INSTRUMENT

    def gauge(self, name: str, help: str = "", labels: tuple = ()):
        return NOOP_INSTRUMENT

    def histogram(self, name: str, help: str = "", cap: int = 512,
                  labels: tuple = ()):
        return NOOP_INSTRUMENT

    def get(self, name: str):
        return None

    def snapshot(self) -> dict:
        return {}

    def to_prometheus(self) -> str:
        return ""


NOOP_REGISTRY = NoopRegistry()
