"""Named host ranges of the port, on the profiler's clock.

Counterpart of ``lens_flare_tpu/utils/profiling.py``, holding one thing:
:func:`span`.  Under a running ``torch.profiler`` (the command line's
``--trace DIR``, a benchmark's traced slice) a span is a range named
``lf.<name>`` on the same kineto host clock as the CUDA runtime calls and
the aten operations it encloses, so a trace names the port's own code
(the renderer's set-up, a tile, a replay, the flare's rebuild) and not only
the torch call that happens to be open.  With no profiler running a span
costs one check and records nothing.  Spans keep no clock and no store:
the profiler records them.

A span is a range of the kind an aten operation opens, not a
``torch.profiler.record_function`` user annotation: it costs a sixth of
one while a profiler runs, draws no copy of itself on the device's
timeline, and a reduction that names each idle gap of the device by the
innermost operation open when it began (``benchmark/benchlib/profiling.py``)
names the port's span where no torch call is open.
"""

from __future__ import annotations

import contextlib

import torch

_profiling = torch.autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast
_NONE = contextlib.nullcontext()


def span(name: str):
    """A context manager: the range ``lf.<name>`` while a profiler runs, else nothing at all."""
    if not _profiling():
        return _NONE
    return _Range(f"lf.{name}")
