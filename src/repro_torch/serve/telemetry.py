"""Typed metrics registry + health/stats endpoint for the serving stack.

Before this module every serving layer kept its own ad-hoc ``stats``
dict — ``RankService``, ``RankQueue``, ``ServePipeline`` each counted into
plain dicts with hand-rolled locking and no shared rendering. This module
replaces those with ONE typed registry per owner:

* ``Counter`` — monotonically increasing event counts (queries served,
  batches flushed, plans spilled). Supports ``set`` too, for counters
  mirrored from a subsystem's own ledger (plan-cache evictions).
* ``Gauge``   — last-write-wins level samples (pending queue depth, live
  cache entries, widest batch so far).
* ``Histogram`` — value distributions over a bounded reservoir (stage
  wall-times, per-column sweep counts, EDF queue waits, spill I/O
  latency). The reservoir is a sliding window of the most recent
  ``window`` observations, so a week-old latency spike ages out of the
  percentiles while ``count``/``sum``/``min``/``max`` stay lifetime-exact.

Metrics are *families*: one name (``queue.class.served``) optionally fans
out over label values (the priority class). ``MetricsRegistry.names()``
enumerates the finite family-name set — the contract the operator runbook
(``docs/OPERATIONS.md``) documents and ``tests/test_telemetry.py``
enforces name-by-name, so the docs cannot silently rot.

**Legacy aliases.** The old stats dicts are load-bearing API: tests,
benches, and the launcher read ``svc.stats["plan_hits"]`` and
``q.stats["flush_vmax"]`` directly and mutate them with ``+=``.
``LegacyStatsDict`` keeps that surface alive as a ``MutableMapping`` view
whose every key is backed by a registry metric — reads return the metric's
value, writes store through — so call sites and ``snapshot_stats()``
renderers did not have to change while the registry became the single
source of truth. ``LabeledView`` does the same for the one nested dict
(``backend_batches``: label value -> count).

``StatsServer`` is the ops endpoint: a stdlib ``ThreadingHTTPServer``
serving ``GET /healthz`` (200 ``ok`` / 503 ``draining`` text) and ``GET
/stats.json`` (the composed snapshot, numpy-safe JSON) on a loopback
port — enough for a probe, a scraper, or a human with curl. See
``docs/OPERATIONS.md`` for the endpoint contract and per-metric reference.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from collections.abc import MutableMapping
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# default histogram reservoir size (recent-window percentiles); matches
# the queue's pre-registry per-class latency window so reported p50/p95
# are unchanged by the migration
DEFAULT_WINDOW = 4096

_KINDS = ("counter", "gauge", "histogram")


class Counter:
    """Monotonic event counter (``set`` allowed for mirrored ledgers)."""

    kind = "counter"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def inc(self, n: int = 1):
        with self._lock:
            self._value += n

    def set(self, v):
        with self._lock:
            self._value = int(v)

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def __iadd__(self, n: int):
        # lets dict-of-metric call sites keep the ``stats["k"] += 1`` idiom
        self.inc(int(n))
        return self

    def __repr__(self):
        return f"Counter({self.value})"


class Gauge:
    """Last-write-wins level sample."""

    kind = "gauge"

    def __init__(self, lock: threading.RLock):
        self._lock = lock
        self._value = 0

    def set(self, v):
        with self._lock:
            self._value = v

    def max(self, v):
        """Ratchet upward (widest batch seen, deepest backlog seen)."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self):
        with self._lock:
            return self._value

    def __repr__(self):
        return f"Gauge({self.value})"


class Histogram:
    """Bounded-reservoir distribution: lifetime count/sum/min/max plus
    percentiles over the most recent ``window`` observations."""

    kind = "histogram"

    def __init__(self, lock: threading.RLock, window: int = DEFAULT_WINDOW):
        self._lock = lock
        self._window = deque(maxlen=int(window))
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        with self._lock:
            self._window.append(v)
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            if not self._window:
                return None
            return float(np.percentile(np.asarray(self._window, float), q))

    def summary(self) -> dict:
        with self._lock:
            win = np.asarray(self._window, float)
        out = {"count": self.count, "sum": self.sum,
               "min": self.min, "max": self.max}
        for q in (50, 95, 99):
            out[f"p{q}"] = (float(np.percentile(win, q))
                            if win.size else None)
        return out

    def __repr__(self):
        return f"Histogram(count={self.count})"


_METRIC_TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of metric families, thread-safe throughout.

    A family is one name + one kind; a labeled family holds one metric
    instance per label value (``registry.counter("service.exit", "residual")``),
    an unlabeled family exactly one. Asking for an existing name with a
    different kind raises — a name means one thing, forever.
    """

    def __init__(self):
        self._lock = threading.RLock()
        # name -> (kind, {label|None: metric})
        self._families: Dict[str, Tuple[str, dict]] = {}

    def _get(self, kind: str, name: str, label: Optional[str], **kw):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {})
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} is a {fam[0]}, not a {kind}")
            m = fam[1].get(label)
            if m is None:
                m = _METRIC_TYPES[kind](self._lock, **kw)
                fam[1][label] = m
            return m

    def counter(self, name: str, label: Optional[str] = None) -> Counter:
        return self._get("counter", name, label)

    def gauge(self, name: str, label: Optional[str] = None) -> Gauge:
        return self._get("gauge", name, label)

    def histogram(self, name: str, label: Optional[str] = None,
                  window: int = DEFAULT_WINDOW) -> Histogram:
        return self._get("histogram", name, label, window=window)

    def names(self) -> List[str]:
        """Sorted family names — the finite set the runbook documents."""
        with self._lock:
            return sorted(self._families)

    def labels(self, name: str) -> List[str]:
        with self._lock:
            kind_fam = self._families.get(name)
            if kind_fam is None:
                return []
            return sorted(k for k in kind_fam[1] if k is not None)

    def kind(self, name: str) -> Optional[str]:
        with self._lock:
            fam = self._families.get(name)
            return None if fam is None else fam[0]

    def snapshot(self) -> dict:
        """Render every family: scalars for counters/gauges, ``summary()``
        dicts for histograms; labeled families nest ``{label: value}``."""
        with self._lock:
            fams = {n: (k, dict(ms)) for n, (k, ms) in self._families.items()}

        def _render(kind, m):
            return m.summary() if kind == "histogram" else m.value

        out = {}
        for name in sorted(fams):
            kind, ms = fams[name]
            if set(ms) == {None}:
                out[name] = _render(kind, ms[None])
            else:
                out[name] = {lbl: _render(kind, m)
                             for lbl, m in sorted(ms.items())}
        return out


class LabeledView(MutableMapping):
    """Dict-face over one labeled counter family (``backend_batches``:
    backend name -> batches). Iteration yields the labels created so far;
    missing labels read as absent (``.get(name, 0)`` via the mixin) and
    spring into existence on write."""

    def __init__(self, registry: MetricsRegistry, name: str):
        self._reg = registry
        self._name = name

    def __getitem__(self, label):
        if label not in self._reg.labels(self._name):
            raise KeyError(label)
        return self._reg.counter(self._name, label).value

    def __setitem__(self, label, v):
        self._reg.counter(self._name, label).set(v)

    def __delitem__(self, label):  # pragma: no cover — not a legacy idiom
        raise TypeError("metrics cannot be deleted")

    def __iter__(self):
        return iter(self._reg.labels(self._name))

    def __len__(self):
        return len(self._reg.labels(self._name))

    def __repr__(self):
        return repr(dict(self))


class LegacyStatsDict(MutableMapping):
    """The old ``stats`` dict surface, backed by registry metrics.

    Construction binds each legacy key to a metric (or a ``LabeledView``
    for nested families); reads return current values, writes store
    through, so ``stats["queries"] += 1`` and ``dict(stats)`` behave
    exactly as before. Read-modify-write call sites keep their original
    outer locks (the service/queue/pipeline locks), unchanged.
    """

    def __init__(self, bindings: Dict[str, object]):
        self._b = dict(bindings)

    def __getitem__(self, key):
        m = self._b[key]
        if isinstance(m, LabeledView):
            return m
        return m.value

    def __setitem__(self, key, v):
        m = self._b[key]
        if isinstance(m, LabeledView):
            raise TypeError(f"{key} is a labeled family; set labels on it")
        m.set(v)

    def __delitem__(self, key):  # pragma: no cover — not a legacy idiom
        raise TypeError("stats keys cannot be deleted")

    def __iter__(self):
        return iter(self._b)

    def __len__(self):
        return len(self._b)

    def __repr__(self):
        return repr(dict(self))


def _json_default(o):
    """numpy scalars/arrays -> plain JSON (snapshot dicts carry both)."""
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def render_json(obj) -> bytes:
    return json.dumps(obj, default=_json_default, indent=1).encode()


class StatsServer:
    """Loopback health/stats HTTP endpoint (stdlib only, daemon threads).

    * ``GET /healthz``    — 200 ``ok`` (or the health detail) while
      healthy, 503 with the detail while draining/unhealthy; text/plain.
    * ``GET /stats.json`` — 200, the composed ``stats_fn()`` snapshot as
      JSON (numpy-safe).
    * anything else       — 404.

    ``port=0`` binds an ephemeral port (read it back off ``.port`` — the
    launcher prints it so probes and tests can find the endpoint).
    """

    def __init__(self, stats_fn: Callable[[], dict],
                 health_fn: Optional[Callable[[], Tuple[bool, str]]] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self._stats_fn = stats_fn
        self._health_fn = health_fn or (lambda: (True, "ok"))
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                try:
                    if self.path == "/healthz":
                        ok, detail = outer._health_fn()
                        self._send(200 if ok else 503,
                                   detail.encode(), "text/plain")
                    elif self.path == "/stats.json":
                        self._send(200, render_json(outer._stats_fn()),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:  # client went away mid-reply
                    pass

            def _send(self, code: int, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # endpoint probes must not spam
                pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="rank-stats-http")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
