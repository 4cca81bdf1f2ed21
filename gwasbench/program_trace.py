"""The program's own spans and counters (``stoat_tpu_torch/trace.py``), as
the per-layer readers of ``program_span`` and ``program_counter`` metrics
see them.

The program keeps its spans and counters in memory while torch.profiler
records, so after a traced window its store holds the window's jobs (the
warm-up job runs unprofiled).  A process that traced earlier windows
holds theirs first: the window's jobs are the last as many root ``job``
spans as the harness timed jobs.  A program without that module (an
older commit) has no store, and every reader returns None.

The trace's clock: one offset a run, the median over the jobs of the
middle of the harness's ``job`` annotation (trace us) less the middle of
the program's root span of the same index (``perf_counter_ns`` / 1000).
The harness's annotation opens before the program's root span and
closes after it, by the calls between them; the middles cancel what the
two ends share, where the starts alone would put every span about
0.1 ms early on the card's host.  When the per-job offsets spread by
more than ``MAX_SPREAD_US`` the spans are not put on the trace's clock:
the reader that needs it returns None and says why in a note.

Tests hand a reader a store of their own as ``ctx.program_store``, a
pair ``(records, counters)`` shaped as ``trace.records()`` and
``trace.counters()`` return them.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from gwasbench.tracing import _union

MAX_SPREAD_US = 2000.0
ROOT = "job"
# the program's layer spans beside the harness's spans of the same layer
LAYERS = (("job", "job"), ("runner", "runner"), ("perm", "perm_pass"),
          ("ingest", "ingest"))


@dataclass
class Window:
    """The window's jobs as the program recorded them."""

    roots: list                      # the root span of each job, in order
    records: list                    # every span of those jobs
    counters: List[Dict[str, int]]   # each job's counters, in order

    @property
    def jobs(self) -> int:
        return len(self.roots)

    def thread_spans(self, i: int) -> list:
        """Job ``i``'s spans on the thread that ran it."""
        root = self.roots[i]
        return [r for r in self.records
                if r.job == root.job and r.thread == root.thread]


def _store(ctx):
    got = getattr(ctx, "program_store", None)
    if got is not None:
        return got
    try:
        from stoat_tpu_torch import trace
    except ImportError:
        return None
    return trace.records(), trace.counters()


def _harness_jobs(ctx) -> List[Tuple[str, float, float]]:
    return sorted((a for a in ctx.annotations if a[0] == ROOT),
                  key=lambda a: a[1])


def window(ctx) -> Optional[Window]:
    """The program's records of the window's jobs, or None (with a note)
    when the program recorded none or fewer jobs than the harness ran."""
    if "_program_window" in ctx.__dict__:
        return ctx.__dict__["_program_window"]
    got = None
    store = _store(ctx)
    harness = _harness_jobs(ctx)
    if store is None:
        ctx.notes.append("program trace: the program has no "
                         "stoat_tpu_torch.trace; its metrics are left out")
    else:
        records, counters = store
        roots = sorted((r for r in records
                        if r.parent is None and r.name == ROOT),
                       key=lambda r: r.start_ns)
        if not harness or len(roots) < len(harness):
            ctx.notes.append(
                f"program trace: {len(roots)} program jobs recorded for "
                f"{len(harness)} harness jobs; its metrics are left out")
        else:
            roots = roots[len(roots) - len(harness):]
            ids = {r.job for r in roots}
            got = Window(roots, [r for r in records if r.job in ids],
                         [dict(counters.get(r.job, {})) for r in roots])
            _layer_note(ctx, got)
    ctx.__dict__["_program_window"] = got
    return got


def _layer_note(ctx, w: Window) -> None:
    parts = []
    for mine, theirs in LAYERS:
        total = sum((r.end_ns - r.start_ns) / 1e9 for r in w.records
                    if r.name == mine) / w.jobs
        harness = ctx.span_seconds(theirs)
        parts.append(f"{mine} {total:.4f}" + (
            "" if harness is None else f" / {harness:.4f}"))
    spans = [c.get("spans", 0) for c in w.counters]
    ctx.notes.append(
        "program trace: s a job, program / harness: " + ", ".join(parts)
        + f"; spans a job {min(spans)}-{max(spans)}")


def offset_us(ctx) -> Optional[float]:
    """The run's offset from the program's clock (us) to the trace's, or
    None (with a note) when there is no window or the jobs' offsets
    spread by more than MAX_SPREAD_US."""
    if "_program_offset" in ctx.__dict__:
        return ctx.__dict__["_program_offset"]
    got = None
    w = window(ctx)
    if w is not None:
        offsets = [h[1] + h[2] / 2 - (r.start_ns + r.end_ns) / 2e3
                   for h, r in zip(_harness_jobs(ctx), w.roots)]
        spread = max(offsets) - min(offsets)
        if spread > MAX_SPREAD_US:
            ctx.notes.append(
                f"program trace: the jobs' clock offsets spread by "
                f"{spread:.1f} us (over {MAX_SPREAD_US:.0f}): its spans are "
                f"not put on the trace's clock")
        else:
            got = statistics.median(offsets)
    ctx.__dict__["_program_offset"] = got
    return got


def thread_seconds(ctx, names: Sequence[str]) -> Optional[float]:
    """Seconds a job in spans named ``names`` on each job's own thread."""
    w = window(ctx)
    if w is None:
        return None
    total = sum((r.end_ns - r.start_ns) / 1e9
                for i in range(w.jobs) for r in w.thread_spans(i)
                if r.name in names)
    return total / w.jobs


def counter_total(ctx, name: str) -> Optional[int]:
    """The counter ``name`` summed over the window's jobs."""
    w = window(ctx)
    if w is None:
        return None
    return sum(c.get(name, 0) for c in w.counters)


def idle_by_stage(ctx) -> Optional[Dict[Optional[str], float]]:
    """{innermost program span on the job's thread: idle seconds of the
    card} over the window's jobs, clipped to the harness's ``job``
    annotations; None keys the idle time under no program span.  None
    without a device trace or a program trace on its clock."""
    if not ctx.on_card or not ctx.device_ops:
        return None
    off = offset_us(ctx)
    if off is None:
        return None
    w = window(ctx)
    busy = _union([(a, b) for _n, a, b in ctx.device_ops])
    out: Dict[Optional[str], float] = {}
    for i, (_n, h0, hdur) in enumerate(_harness_jobs(ctx)):
        spans = [(r.start_ns / 1e3 + off, r.end_ns / 1e3 + off, r.name)
                 for r in w.thread_spans(i)]
        for a, b in _gaps(busy, h0, h0 + hdur):
            cuts = sorted({a, b} | {t for s, e, _ in spans
                                    for t in (s, e) if a < t < b})
            for lo, hi in zip(cuts, cuts[1:]):
                mid = (lo + hi) / 2
                inner = [(s, -e, n) for s, e, n in spans if s <= mid < e]
                name = max(inner)[2] if inner else None
                out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return out


def _gaps(busy: List[Tuple[float, float]], lo: float, hi: float):
    """The parts of [lo, hi] outside the sorted, disjoint ``busy``."""
    cursor = lo
    for a, b in busy:
        if b <= cursor:
            continue
        if a >= hi:
            break
        if a > cursor:
            yield cursor, a
        cursor = max(cursor, b)
    if cursor < hi:
        yield cursor, hi
