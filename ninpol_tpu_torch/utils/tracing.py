"""The port's one tracing mechanism: named spans and counters.

``span(name)`` always enters ``torch.autograd.profiler.record_function(
name)``, so the span lands in any torch.profiler trace beside the
kernels it launched.  While the recorder is on it also keeps the span in
memory: its name, start and end, its parent span, and the id of the
public call it belongs to (every span of one ``Interpolator.load_data``,
``compute_diffusion_magnitude``, ``prepare_interpolator`` or
``interpolate`` shares one id).  Start and end are on the profiler
trace's clock: nanoseconds since the epoch, as ``baseTimeNanoseconds +
ts`` of an exported trace reads them, taken from ``time.monotonic_ns``
with the offset to ``time.time_ns`` fixed when the recorder turns on, so
a jump of the wall clock moves no span.  ``count(name, n)`` adds to a
counter.  ``snapshot()`` copies what was recorded; ``reset()`` clears it.

The recorder is on inside public calls (``public``) made while
``NINPOL_TPU_PHASES=1``, read once as the outermost one starts, and off
between them.  It keeps what it recorded since the variable was last
seen turning on (so a caller that sets the variable around a stretch of
calls reads that stretch's totals).  Off, a span is only its
``record_function`` range: no clock read, nothing kept; counters do not
move.  The recorder serves the one thread that drives
the Interpolator.

Spans (``ninpol_tpu_torch.`` + name) and counters, where they are taken:

  load_data, diff_mag        ``Interpolator.load_data`` and
                             ``compute_diffusion_magnitude``
  prepare                    GLS: prepare(), whose phases follow
  face_table                 GLS: the face table and Neumann flags, with
    face_build               its numpy build and
    face_upload              their copies to the device
  class_plan, dispatch,      GLS: the stencil classes, the chunk loop,
  n_bad_sync,                the count of nodes not converged,
  exact_fallback, host_write the exact path and the copy to the host
  gls_gather, gls_solve,     GLS: each chunk's steps
  gls_epilogue, gls_exact
  mesh_gather, mesh_merge    on a mesh: cross-device gathers and merges
  csr_assembly               ``interpolate``'s scipy CSR after its
                             ``prepare_interpolator``

  h2d_bytes, d2h_bytes       bytes copied host to card and card to host
  host_syncs                 waits of the host for the card
  n_bad                      nodes sent to the GLS exact fallback
"""
from __future__ import annotations

import collections
import functools
import os
import time

import torch
from torch.autograd.profiler import record_function

PREFIX = "ninpol_tpu_torch."
ENV = "NINPOL_TPU_PHASES"
# finished spans kept; older ones are dropped (their totals stay)
MAX_SPANS = 1 << 16

# a finished span; start_ns and end_ns on the profiler trace's clock
Span = collections.namedtuple("Span",
                              "sid parent call name start_ns end_ns")


class _Recorder:

    def __init__(self):
        self.on = False         # recording now
        self.armed = False      # the switch at the last public call
        self.offset_ns = 0
        self.depth = 0          # public calls open
        self.call = 0           # id of the newest public call
        self.stack = []         # open spans, innermost last
        self.next_sid = 0
        self.reset()

    def reset(self):
        self.totals = {}        # name -> [count, ns]
        self.counters = {}
        self.spans = collections.deque(maxlen=MAX_SPANS)

    def switch(self, on):
        if on:
            if not self.armed:  # a new recording
                self.reset()
                self.offset_ns = time.time_ns() - time.monotonic_ns()
            self.call += 1
        self.armed = self.on = on


_rec = _Recorder()


class _Live:
    """A span while the recorder is on."""

    __slots__ = ("name", "range", "sid", "parent", "call", "start_ns")

    def __init__(self, name):
        self.name = name
        self.range = record_function(name)

    # Each clock is read just before the range's own enter and exit, which
    # stamp their event first: a slow enter (the profiler's first event, a
    # preempted thread) then moves neither the span nor the event.
    def __enter__(self):
        rec = _rec
        self.start_ns = time.monotonic_ns() + rec.offset_ns
        self.range.__enter__()
        self.sid = rec.next_sid
        rec.next_sid += 1
        self.parent = rec.stack[-1].sid if rec.stack else None
        self.call = rec.call
        rec.stack.append(self)
        return self

    def __exit__(self, *exc):
        rec = _rec
        end_ns = time.monotonic_ns() + rec.offset_ns
        self.range.__exit__(*exc)
        rec.stack.pop()
        total = rec.totals.setdefault(self.name, [0, 0])
        total[0] += 1
        total[1] += end_ns - self.start_ns
        rec.spans.append(Span(self.sid, self.parent, self.call, self.name,
                              self.start_ns, end_ns))
        return False


def span(name):
    """A context manager: the ``record_function`` range ``name`` and,
    while the recorder is on, the span recorded."""
    return _Live(name) if _rec.on else record_function(name)


def count(name, n):
    """Add ``n`` to counter ``name`` while the recorder is on."""
    rec = _rec
    if rec.on:
        rec.counters[name] = rec.counters.get(name, 0) + n


def public(fn):
    """Decorate a public call of the Interpolator: the outermost one reads
    the switch (``NINPOL_TPU_PHASES``) and, on, opens a new call id; the
    recorder is off again once it returns."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        rec = _rec
        if not rec.depth:
            rec.switch(os.environ.get(ENV) == "1")
        rec.depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            rec.depth -= 1
            if not rec.depth:
                rec.on = False
    return call


def children(top):
    """The finished spans whose parent is ``top`` (a span ``span()``
    returned and entered), in the order they ended; None where ``top``
    was not recorded."""
    sid = getattr(top, "sid", None)
    if sid is None:
        return None
    out = []
    for s in reversed(_rec.spans):
        if s.end_ns < top.start_ns:
            break
        if s.parent == sid:
            out.append(s)
    return out[::-1]


def snapshot():
    """A copy of what was recorded: ``totals`` {span name: (count, ns)},
    ``counters`` {name: int} and ``spans`` [Span], the newest MAX_SPANS
    in the order they ended."""
    rec = _rec
    return {"totals": {k: tuple(v) for k, v in rec.totals.items()},
            "counters": dict(rec.counters), "spans": list(rec.spans)}


def reset():
    """Clear the totals, counters and spans (open spans still end)."""
    _rec.reset()


# -- the sites where the host and the card meet --------------------------

def crosses(device):
    """Whether a copy between the host and ``device`` crosses to a card."""
    return device.type != "cpu"


def upload(a, device):
    """``torch.as_tensor(a, device=device)`` (``a`` a host array or
    tensor): a copy to the card, counted with its bytes and as a wait of
    the host for the card's stream, which a copy from pageable memory
    is."""
    t = torch.as_tensor(a, device=device)
    if _rec.on and crosses(t.device):
        count("h2d_bytes", t.element_size() * t.numel())
        count("host_syncs", 1)
    return t


def to_host(t):
    """``t.cpu()``, counted with its bytes and as a wait where ``t`` is on
    the card."""
    if _rec.on and crosses(t.device):
        count("d2h_bytes", t.element_size() * t.numel())
        count("host_syncs", 1)
    return t.cpu()
