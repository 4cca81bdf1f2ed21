"""The traced run: the harness's own spans around the program's layers,
the kernel calls' shapes, and torch.profiler over the whole window.

Spans are taken from here, around module attributes of the program that
its callers look up at call time (a span inside the program is for the
program to add):

  job        ``stoat_tpu_torch.cli.main``, one whole job
  runner     ``pipeline.runner.run_vcf_analysis``, the main table (the CLI
             imports it at call time)
  perm_pass  ``pipeline.permutation.run_permutation_test``, the pass
  ingest     each ``next()`` of ``pipeline.runner.iter_chromosome_matrices``
             (the runner calls it by its module global, on its prefetch
             thread; the pass imports it from the runner at call time)

and the shapes of the kernels that rooflines read: ``perm_ols_stats`` and
``score_perm_stats`` of ``pipeline.permutation`` (``_chunk_pvalues`` calls
them by their module globals).  Each span is also a
``torch.profiler.record_function`` named ``gwasbench.<span>``, so the
trace can say what the host was doing in each of the card's idle gaps.

The profiler window opens with LEAD_SPINS launches of
``torch.cuda._sleep`` before the window's own annotation: the profiler on
the card's machine drops the first device records of a window (a frozen
copy of chip_smoke.py profile_window's lead, lines 5096-5138 at the
commit that added this benchmark).  Device operations (kernels, copies,
sets) are clipped to the window's annotation; their union is the busy
time.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

__all__ = ["Tracer", "Context", "LEAD_SPINS"]

LEAD_SPINS = 4
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "gwasbench."


class Tracer:
    """Installs the spans and shape probes, runs the profiler over the
    window, and turns what it saw into a :class:`Context`."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.spans: Dict[str, List[float]] = {}
        self.calls: Dict[str, List[Dict[str, int]]] = {}
        self._lock = threading.Lock()
        self._undo = []
        self._trace: Optional[dict] = None

    # -------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str):
        from torch.profiler import record_function
        t0 = time.perf_counter()
        try:
            with record_function(PREFIX + name):
                yield
        finally:
            with self._lock:
                self.spans.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def _patch(self, module, attr, make):
        real = getattr(module, attr)
        setattr(module, attr, make(real))
        self._undo.append((module, attr, real))

    def install(self) -> None:
        from stoat_tpu_torch.pipeline import permutation, runner
        tracer = self

        def spanned(name):
            def make(real):
                def wrapper(*args, **kwargs):
                    with tracer.span(name):
                        return real(*args, **kwargs)
                return wrapper
            return make

        def ingest(real):
            def wrapper(*args, **kwargs):
                gen = real(*args, **kwargs)
                try:
                    while True:
                        with tracer.span("ingest"):
                            try:
                                item = next(gen)
                            except StopIteration:
                                return
                        yield item
                finally:
                    gen.close()
            return wrapper

        def shapes(name, of):
            def make(real):
                def wrapper(*args, **kwargs):
                    with tracer._lock:
                        tracer.calls.setdefault(name, []).append(of(*args))
                    return real(*args, **kwargs)
                return wrapper
            return make

        self._patch(runner, "run_vcf_analysis", spanned("runner"))
        self._patch(permutation, "run_permutation_test",
                    spanned("perm_pass"))
        self._patch(runner, "iter_chromosome_matrices", ingest)
        self._patch(permutation, "perm_ols_stats", shapes(
            "perm_ols", lambda X, used, ncols, phenos: dict(
                S=X.shape[0], N=X.shape[1], P=X.shape[2],
                K=phenos.shape[0])))
        self._patch(permutation, "score_perm_stats", shapes(
            "score_perm", lambda D, used, Vinv, e: dict(
                S=D.shape[0], N=D.shape[1], PT=D.shape[2], K=e.shape[0])))

    def uninstall(self) -> None:
        while self._undo:
            module, attr, real = self._undo.pop()
            setattr(module, attr, real)

    # -------------------------------------------------------- the window
    @contextmanager
    def window(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function
        activities = [ProfilerActivity.CPU]
        if self.on_card:
            activities.append(ProfilerActivity.CUDA)
        self.install()
        try:
            with profile(activities=activities) as prof:
                if self.on_card:
                    for _ in range(LEAD_SPINS):
                        torch.cuda._sleep(1000)
                with record_function(PREFIX + "window"):
                    yield
                if self.on_card:
                    torch.cuda.synchronize()
        finally:
            self.uninstall()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="trace-")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                self._trace = json.load(fh)
        finally:
            os.remove(path)

    def context(self, jobs: int, peak_bytes: int, card: str) -> "Context":
        events = (self._trace or {}).get("traceEvents", [])
        spans, device = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e["dur"])
            if cat in DEVICE_CATS:
                device.append((e.get("name", "?"), ts, dur))
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(PREFIX):
                spans.append((e["name"][len(PREFIX):], ts, dur))
        win = [s for s in spans if s[0] == "window"]
        lo, hi = (win[0][1], win[0][1] + win[0][2]) if win else (None, None)
        inside = [] if lo is None else [
            (n, max(ts, lo), min(ts + d, hi)) for n, ts, d in device
            if ts + d > lo and ts < hi]
        return Context(jobs=jobs, peak_bytes=peak_bytes, card=card,
                       spans=dict(self.spans), calls=dict(self.calls),
                       device_ops=inside, annotations=[
                           s for s in spans if s[0] != "window"],
                       trace_window=(lo, hi), on_card=self.on_card)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclass
class Context:
    """What the per-layer readers read."""

    jobs: int
    peak_bytes: int
    card: str
    spans: Dict[str, List[float]]
    calls: Dict[str, List[Dict[str, int]]]
    device_ops: List[Tuple[str, float, float]]   # (name, start, end) us
    annotations: List[Tuple[str, float, float]]  # (span, start, dur) us
    trace_window: Tuple[Optional[float], Optional[float]]
    on_card: bool
    notes: List[str] = field(default_factory=list)

    def span_seconds(self, name: str) -> Optional[float]:
        """Total seconds in span ``name`` a job, None when never entered."""
        if name not in self.spans or not self.jobs:
            return None
        return sum(self.spans[name]) / self.jobs

    @property
    def window_s(self) -> Optional[float]:
        lo, hi = self.trace_window
        return None if lo is None else (hi - lo) / 1e6

    @property
    def busy_s(self) -> Optional[float]:
        if not self.on_card or self.window_s is None or not self.device_ops:
            return None
        return sum(b - a for a, b in _union(
            [(a, b) for _n, a, b in self.device_ops])) / 1e6

    def kernel_records(self, pattern) -> List[float]:
        """Durations (s) of the device kernels whose name ``pattern``
        (a compiled regex) matches."""
        return [(b - a) / 1e6 for n, a, b in self.device_ops
                if pattern.search(n)]

    def breakdown(self) -> Optional[Dict]:
        if self.window_s is None:
            return None
        by_op: Dict[str, float] = {}
        for n, a, b in self.device_ops:
            by_op[n] = by_op.get(n, 0.0) + (b - a) / 1e6
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        lo, hi = self.trace_window
        busy = _union([(a, b) for _n, a, b in self.device_ops])
        gaps, cursor = [], lo
        for a, b in busy + [(hi, hi)]:
            if a > cursor:
                gaps.append((cursor, a))
            cursor = max(cursor, b)
        named = []
        for a, b in gaps:
            mid = (a + b) / 2
            covering = [s for s in self.annotations
                        if s[1] <= mid <= s[1] + s[2]]
            label = min(covering, key=lambda s: s[2])[0] if covering \
                else "harness"
            named.append([label, (b - a) / 1e6])
        named.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": named[:10]}
