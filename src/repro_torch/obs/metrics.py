"""Lightweight in-process metrics registry: counters, gauges, histograms.

A deliberately small Prometheus-shaped surface for the serving subsystem,
replacing ad-hoc ``dict.get(k, 0) + 1`` accumulation where that was a
drop-in (the cluster router's shed/fault books are the first client).  No
background threads, no wall-clock, no global state: a registry is an
explicit object you thread to whoever should report into it, and
``snapshot()`` is the only read path — a plain nested dict, safe to
serialise or diff in tests.

* ``Counter``   — monotone totals, optionally labelled:
  ``c = reg.counter("serve.shed", labels=("reason", "chip"))`` then
  ``c.inc(reason="timeout", chip=3)``.  ``group_sum("reason")`` re-aggregates
  over one label (how the router derives its fleet-global ``shed_reasons``
  from the per-chip books), ``by_label("chip")`` nests the remaining labels
  under each value of one.
* ``Gauge``     — last-written value (``set``/``add``), same labelling.
* ``Histogram`` — fixed buckets chosen at creation; ``observe(v)`` bins it.
  ``snapshot`` reports per-bucket counts plus count/sum, so means and
  coarse percentiles are recoverable without storing samples.

Label values are normalised to strings in snapshots (Prometheus-style);
ints are accepted at the call site for convenience (chip indices).
"""

from __future__ import annotations

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class _Labelled:
    """Shared label plumbing: values keyed by a tuple in ``labels`` order."""

    def __init__(self, name: str, labels: tuple[str, ...] = ()):
        self.name = name
        self.labels = tuple(labels)
        self._values: dict[tuple[str, ...], float] = {}

    def _key(self, kw: dict) -> tuple[str, ...]:
        if set(kw) != set(self.labels):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, got {tuple(kw)}")
        return tuple(str(kw[label]) for label in self.labels)

    def value(self, **kw) -> float:
        return self._values.get(self._key(kw), 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def group_sum(self, label: str) -> dict[str, float]:
        """Aggregate over every label except ``label``."""
        i = self.labels.index(label)
        out: dict[str, float] = {}
        for key, v in self._values.items():
            out[key[i]] = out.get(key[i], 0.0) + v
        return out

    def by_label(self, label: str) -> dict[str, dict[tuple[str, ...], float]]:
        """Nest the remaining label tuples under each value of ``label``."""
        i = self.labels.index(label)
        out: dict[str, dict[tuple[str, ...], float]] = {}
        for key, v in self._values.items():
            rest = key[:i] + key[i + 1:]
            out.setdefault(key[i], {})[rest] = v
        return out

    def snapshot(self) -> dict:
        if not self.labels:
            return {"value": self._values.get((), 0.0)}
        return {"labels": list(self.labels),
                "values": {",".join(k): v for k, v in sorted(self._values.items())}}


class Counter(_Labelled):
    """Monotone counter; ``inc`` rejects negative steps."""

    def inc(self, n: float = 1.0, **kw) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        key = self._key(kw)
        self._values[key] = self._values.get(key, 0.0) + n


class Gauge(_Labelled):
    """Last-written value (e.g. current backlog, peak watermarks via max)."""

    def set(self, v: float, **kw) -> None:
        self._values[self._key(kw)] = float(v)

    def add(self, v: float, **kw) -> None:
        key = self._key(kw)
        self._values[key] = self._values.get(key, 0.0) + float(v)

    def max(self, v: float, **kw) -> None:
        key = self._key(kw)
        self._values[key] = max(self._values.get(key, float("-inf")), float(v))


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are inclusive upper bounds (an
    implicit +inf bucket catches the rest)."""

    def __init__(self, name: str, buckets: tuple[float, ...]):
        if not buckets or list(buckets) != sorted(buckets):
            raise ValueError(f"{name}: buckets must be sorted and non-empty")
        self.name = name
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.n = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        self.n += 1
        self.sum += v
        for i, bound in enumerate(self.buckets):
            if v <= bound:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else 0.0

    def snapshot(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "count": self.n, "sum": self.sum}


class MetricsRegistry:
    """Get-or-create home for named instruments; one per serving run."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, labels: tuple[str, ...] = ()) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name, labels)
        elif c.labels != tuple(labels):
            raise ValueError(f"counter {name} re-registered with labels "
                             f"{tuple(labels)} != {c.labels}")
        return c

    def gauge(self, name: str, labels: tuple[str, ...] = ()) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name, labels)
        elif g.labels != tuple(labels):
            raise ValueError(f"gauge {name} re-registered with labels "
                             f"{tuple(labels)} != {g.labels}")
        return g

    def histogram(self, name: str, buckets: tuple[float, ...] = ()) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, buckets)
        elif buckets and h.buckets != tuple(float(b) for b in buckets):
            raise ValueError(f"histogram {name} re-registered with different buckets")
        return h

    def snapshot(self) -> dict:
        """Nested plain-dict view of everything registered (sorted names)."""
        return {
            "counters": {k: v.snapshot() for k, v in sorted(self._counters.items())},
            "gauges": {k: v.snapshot() for k, v in sorted(self._gauges.items())},
            "histograms": {k: v.snapshot() for k, v in sorted(self._histograms.items())},
        }
