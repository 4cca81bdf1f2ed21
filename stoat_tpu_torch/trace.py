"""Spans and counters of the port's host stages, recorded only while
``torch.profiler`` records.

An operator who profiles a job sees its host stages beside the card's
kernels::

    from torch.profiler import ProfilerActivity, profile
    from stoat_tpu_torch import cli, trace

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        cli.main(["vcf", ...])
    prof.export_chrome_trace("job.json")     # open in Perfetto

Each span is a ``torch.profiler.record_function`` named ``stoat.<span>``,
on the profiler's clock, so in Perfetto the parse, the ingest waits, the
packing, the uploads and the waits on the card sit on the host's rows
above the kernels they held up.  Each span is also kept here, with the
counters, for totals: :func:`records` (name, thread, start and end from
``time.perf_counter_ns()``, its id, the id of the span it opened under
and the id of its job) and :func:`counters` (per job).  :func:`clear`
empties the store, which otherwise keeps whatever was recorded while a
profiler ran.

With no profiler recording, :func:`span` returns one shared context that
does nothing and :func:`count` returns at once: the cost is
``torch.autograd._profiler_enabled()``, the check that
``record_function`` itself makes (and none before torch is imported: the
host-only commands never import it).  The profiler's state belongs to
the thread that started it: a thread that the program starts records
inside :func:`adopt` of the :func:`current` span of its starter.

Spans wrap stages, never rows or snarls.  The root span ``job`` (each
``cli.main``) starts a new job id; every span and counter under it, on
any thread that adopted one of its spans, carries that id.  The spans
and counters of the program (span names as recorded; ``stoat.`` in the
profiler):

  job, cli.parse, cli.snarls,
  cli.release                         cli.py
  runner, runner.wait_ingest, runner.wait_tokens, runner.pack,
  runner.dispatch, runner.wait_writer pipeline/runner.py
  runner.eqtl_pairs, runner.eqtl_wait_card,
  runner.eqtl_write                   pipeline/runner.py, the eQTL mode
  perm, perm.ingest, perm.pack, perm.rows, perm.dispatch,
  perm.wait_card, perm.write          pipeline/permutation.py
  ingest                              a VCF reader's open, each
                                      chromosome and its close
  upload                              convert.upload
  counters: h2d_bytes (convert.upload), perm.snarls_computed,
  perm.snarls_tested (pipeline/permutation.py), eqtl.calls,
  eqtl.snarls, eqtl.pairs, eqtl.genes, eqtl.samples, eqtl.columns
  (pipeline/runner.py, each eQTL OLS call), snarl_file.rows (the
  snarl file's rows read into columns), snarl_file.objects (SnarlData
  built from those columns) (io/snarl_file.py), spans (records a job)
"""

from __future__ import annotations

import functools
import itertools
import sys
import threading
import time
from typing import Dict, Iterable, Iterator, List, NamedTuple, Optional

__all__ = ["PREFIX", "Record", "span", "spanned", "count", "each",
           "current", "adopt", "records", "counters", "clear"]

PREFIX = "stoat."


class Record(NamedTuple):
    """One closed span; times are ``time.perf_counter_ns()``."""

    name: str
    thread: int
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    job: int


class _Local(threading.local):
    def __init__(self):
        self.stack: list = []     # this thread's open spans, innermost last


_lock = threading.Lock()
_local = _Local()
_records: List[Record] = []
_counters: Dict[int, Dict[str, int]] = {}
_ids = itertools.count(1)
_jobs = itertools.count(1)
_job = 0                       # the job of the newest root span


def _recording() -> bool:
    """torch.profiler records on this thread, or the thread adopted a
    recorded span."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd._profiler_enabled():
        return True
    return bool(_local.stack)


class _Off:
    """The shared span of a thread that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "job", "_start", "_rf")

    def __init__(self, name: str, root: bool):
        global _job
        stack = _local.stack
        top = stack[-1] if stack else None
        self.name = name
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        if root:
            self.job = _job = next(_jobs)
        else:
            self.job = top.job if top is not None else _job

    def __enter__(self):
        from torch.profiler import record_function
        _local.stack.append(self)
        self._rf = record_function(PREFIX + self.name)
        self._rf.__enter__()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        _local.stack.pop()
        rec = Record(self.name, threading.get_ident(), self._start, end,
                     self.id, self.parent, self.job)
        with _lock:
            _records.append(rec)
            job = _counters.setdefault(self.job, {})
            job["spans"] = job.get("spans", 0) + 1
        return False


def span(name: str, root: bool = False):
    """A context manager around one stage; ``root`` starts a new job."""
    if _recording():
        return _Span(name, root)
    return _OFF


def spanned(name: str, root: bool = False):
    """Decorator: each call of the function inside span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name, root):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the current job."""
    if not _recording():
        return
    stack = _local.stack
    job = stack[-1].job if stack else _job
    with _lock:
        got = _counters.setdefault(job, {})
        got[name] = got.get(name, 0) + int(n)


def each(name: str, iterable: Iterable) -> Iterator:
    """Yield from ``iterable``, each ``next()`` inside span ``name`` (the
    span closes before the item goes to the consumer)."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


def current():
    """The innermost open span of this thread, or None when it records
    nothing: hand it to :func:`adopt` on a thread this one starts."""
    stack = _local.stack
    return stack[-1] if stack else None


class adopt:
    """On another thread, open spans under ``parent`` (from
    :func:`current`) and in its job; does nothing for None."""

    __slots__ = ("_parent",)

    def __init__(self, parent):
        self._parent = parent

    def __enter__(self):
        if self._parent is not None:
            _local.stack.append(self._parent)
        return self

    def __exit__(self, *exc):
        if self._parent is not None:
            _local.stack.pop()
        return False


def records() -> List[Record]:
    """Every span recorded since the last :func:`clear`, in closing
    order."""
    with _lock:
        return list(_records)


def counters() -> Dict[int, Dict[str, int]]:
    """{job id: {counter: total}} since the last :func:`clear`."""
    with _lock:
        return {job: dict(c) for job, c in _counters.items()}


def clear() -> None:
    with _lock:
        _records.clear()
        _counters.clear()
