"""The port's spans: one table of them and one context manager.

``SPANS`` names every span the program opens, with its id, the span it
nests in (where it is reached inside one) and its kind:

* a device span times work on the device. On a CUDA device ``span``
  launches a marker kernel (``csrc/span_mark.cu``) on the current stream at
  entry and at exit, eagerly or into a CUDA graph's capture, so the markers
  of a captured step or chunk run again on every replay. Each marker writes
  the card's global timer into the span's two slots of a device table; the
  kernel's name carries the span's id, so a profiler's device trace shows
  where each span opens and closes (``benchmark/spans.py`` reads them).
* a host span times host work (the hand-off to a captured step, a frame's
  copies); it stamps ``time.perf_counter_ns`` into a host table.

Every span also opens a ``torch.profiler.record_function`` range of its
name, which a profiler sees on the host while the code runs eagerly or is
captured (not at a replay). A device span on the CPU is stamped on the host
clock.

``span_ms`` gives each span's duration in its last run: on the card, the
last replay's, read from the device table without a profiler. The markers
are not K-kernels: ``ops.kernel_counters`` does not count them.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

DEVICE, HOST = "device", "host"


class Span(NamedTuple):
    name: str
    id: int  # the marker's id: slots 2 * id (entry) and 2 * id + 1 (exit)
    parent: Optional[str]  # the span it nests in, where one encloses it
    kind: str  # DEVICE or HOST


SPANS = (
    Span("train.render_loss", 0, None, DEVICE),  # render_rays and the loss terms
    Span("render.importance", 1, "train.render_loss", DEVICE),  # the importance sampler
    Span("render.background", 2, "train.render_loss", DEVICE),  # the background field
    Span("render.foreground", 3, "train.render_loss", DEVICE),  # the SDF and colour field
    Span("train.backward", 4, None, DEVICE),  # loss.backward()
    Span("train.optimizer", 5, None, DEVICE),  # the clip and the update
    Span("train.inputs", 6, None, HOST),  # a captured dispatch's hand-off
    Span("serve.frame_in", 7, None, HOST),  # a frame's padding and copy to the device
    Span("serve.frame_out", 8, None, HOST),  # a frame's fetch to the host
    # the hash-grid SDF net (models/hash_sdf.py): each encoding (K13), nested
    # where it is called (the importance sampler, the taps); the table's
    # scatter-add (K14) inside train.backward; the numerical gradient's
    # evaluations (the point and its 4 taps) and the Laplacian
    Span("field.hash_encode", 9, None, DEVICE),
    Span("field.hash_grad", 10, "train.backward", DEVICE),
    Span("field.taps", 11, "render.foreground", DEVICE),
)
BY_NAME = {s.name: s for s in SPANS}

_tables: dict = {}  # CUDA device index -> int64 (2 * len(SPANS),) device table
_host: dict = {}  # span name -> (entry ns, exit ns) of its last host-timed run
_last: dict = {}  # span name -> CUDA device index of its last run, or None (host clock)


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def prepare(device) -> Optional[torch.Tensor]:
    """The device table of a CUDA ``device`` (None elsewhere), allocated on
    first call. A capture calls it first, so that the table is not taken
    from the graph's private pool."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    i = _index(dev)
    table = _tables.get(i)
    if table is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("tracing.prepare(device) must run before a CUDA graph's capture")
        table = _tables[i] = torch.zeros(2 * len(SPANS), dtype=torch.int64,
                                         device=torch.device("cuda", i))
    return table


def _mark(table: torch.Tensor, sid: int, end: int) -> None:
    from .ops.build import check, kernels, stream_handle

    check("span_mark", kernels().nw_span_mark(table.data_ptr(), sid, end,
                                              stream_handle(table.device)))


@contextlib.contextmanager
def span(name: str, device=None):
    """Time the block as span ``name`` of ``SPANS``; ``device`` is where a
    device span's work runs (markers on a CUDA device, else the host clock)."""
    s = BY_NAME[name]
    dev = None if device is None else torch.device(device)
    with record_function(name):
        if s.kind == DEVICE and dev is not None and dev.type == "cuda":
            table = prepare(dev)
            _mark(table, s.id, 0)
            yield
            _mark(table, s.id, 1)
            _last[name] = _index(dev)
        else:
            t0 = time.perf_counter_ns()
            yield
            _host[name] = (t0, time.perf_counter_ns())
            _last[name] = None


def span_ms() -> dict:
    """{span name: ms} of each span's last run (a device table is read with
    one copy to the host, which waits for the current stream)."""
    read = {i: _tables[i].cpu().tolist() for i in set(_last.values()) if i is not None}
    out = {}
    for name, where in _last.items():
        if where is None:
            t0, t1 = _host[name]
        else:
            sid = BY_NAME[name].id
            t0, t1 = read[where][2 * sid], read[where][2 * sid + 1]
            if not (0 < t0 <= t1):  # captured and not yet replayed
                continue
        out[name] = (t1 - t0) * 1e-6
    return out


def reset() -> None:
    """Forget every span's last run: the host stamps and the device tables'
    slots. A span captured in a graph stays known and reads again once the
    graph has replayed."""
    _host.clear()
    for name in [k for k, where in _last.items() if where is None]:
        del _last[name]
    for table in _tables.values():
        table.zero_()
