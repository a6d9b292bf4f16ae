"""Captured CUDA graphs of the port's hot programs, replayed per call.

The port's counterpart of the JAX package's ``jax.jit`` sites: the
samples of a tile's ``render_wavefront`` (``lens_flare_tpu/renderer.py:37``)
and of a chunk's ``render_batch`` (``:38``), each replayed once per sample
index (``Renderer._sampler``), and the ghost buffers
(``flare/pipeline.py:39`` and ``lens/realistic.py:315``).  On a CUDA
device a :class:`Programs` cache
captures each program once per static key (``torch.cuda.graph``, after one
eager warm-up on a side stream) and replays it; the tensors that change
between calls are copied into the program's static input buffers first.
On the CPU, and inside :func:`disabled` (the counterpart of
``jax.disable_jit()``), the function runs eagerly and nothing is cached.

A :class:`Step` is the counterpart of a jitted optimisation step
(``lens_flare_tpu/diff/render.py:91``, ``diff/optimize.py:71``,
``parallel/render.py:88``): the forward pass, the loss, ``backward()``
and the optimiser's update as one captured program per input shape.  Its
first call is the warm-up and is step 1; the second captures and replays,
which is step 2; so the steps taken are the calls made, as when eager.

A capture or a replay that fails raises; nothing falls back to eager.

The wrappers of ``ops/intersect_cuda.py`` count kernel launches on the
host, which a replay does not run: a capture records how many launches of
each kernel it took in, and every replay adds them (the warm-up's and the
capture's own counts are taken back out), so a replayed frame counts what
an eager one does.  Each :class:`Programs` counts its replays and the inputs
they copy into static buffers (``replays``, ``copies_in``), as it sums its
capture seconds (``capture_s``).
"""

from __future__ import annotations

import contextlib
import contextvars
import gc
import time

import torch

from .ops.intersect_cuda import KERNELS
from .parallel.mesh import device_scope
from .utils.profiling import span

_eager = contextvars.ContextVar("lens_flare_tpu_torch_eager", default=False)


@contextlib.contextmanager
def disabled():
    """Run every program eagerly inside the block, as ``jax.disable_jit()`` does; blocks nest."""
    token = _eager.set(True)
    try:
        yield
    finally:
        _eager.reset(token)


def launch_counts() -> dict:
    return {k: v.launches for k, v in KERNELS.items()}


def _flat(out):
    return (out,) if torch.is_tensor(out) else tuple(out)


class Program:
    """One captured program: its graph, static inputs and outputs, and the launches it records.

    ``graph`` is anything with a ``replay()`` method (a ``torch.cuda.CUDAGraph``);
    ``fn``, the captured function, is kept so that the tensors its closure
    holds, which the graph reads by address, live as long as the program.
    """

    def __init__(self, fn, graph, inputs, outputs, launches: dict, single: bool):
        self.fn = fn
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.single = single  # the function returned one tensor, not a tuple
        self.capture_s = 0.0  # host seconds of its warm-up, capture and instantiation

    def replay(self, inputs):
        """Copy ``inputs`` (of the captured shapes, dtypes and device) into the static buffers, replay,
        count the launches; new output tensors."""
        with span("compiled.replay"):
            with span("compiled.copy_in"):
                for s, x in zip(self.inputs, inputs):
                    s.copy_(x)
            with span("compiled.launch"):
                self.graph.replay()
            for k, n in self.launches.items():
                KERNELS[k].launches += n
            # the static outputs are overwritten by the next replay of any program sharing the pool
            with span("compiled.clone"):
                out = tuple(o.clone() for o in self.outputs)
            return out[0] if self.single else out


class Programs:
    """Captured programs of one owner (a renderer's frames, a flare pipeline's ghosts), one per key.

    ``run(key, fn, *inputs)`` returns ``fn(*inputs)``: eagerly on the CPU
    or under :func:`disabled`, else through the program captured for
    ``key`` and the inputs' shapes, dtypes and device.  ``fn`` takes and
    returns tensors (one, or a tuple); what it reads besides its inputs
    (scene tables, settings) is captured by address and must stay alive
    and unchanged in shape while the program is cached: its owner
    :meth:`clear` s the cache when they change.  The programs share one
    memory pool per device, and replays run in the order of the calls, on
    the current stream.  A program belongs to its inputs' device: on a mesh
    (``parallel/``) each device captures its own, under that device, on a
    side stream of it, and the shards of one device share theirs.
    """

    def __init__(self):
        self._programs: dict = {}
        self._pools: dict = {}
        self.capture_s = 0.0  # host seconds spent capturing: warm-up, capture, instantiation
        self.replays = 0  # programs replayed
        self.copies_in = 0  # inputs copied into the programs' static buffers, one per input per replay

    def __len__(self) -> int:
        return len(self._programs)

    def capture_seconds(self) -> list:
        """(key, input shapes, seconds) of each cached program's capture."""
        return [(key, [shape for shape, _, _ in inputs], prog.capture_s)
                for (key, inputs), prog in self._programs.items()]

    def clear(self) -> None:
        self._programs.clear()

    def run(self, key, fn, *inputs):
        if not _captures(inputs[0]) or _eager.get():
            return fn(*inputs)
        return self.replay(key, fn, inputs, inputs[0].device)

    def replay(self, key, fn, inputs, dev, warm_up: bool = True):
        """``fn(*inputs)`` through the program of ``key`` and the inputs' signature on ``dev``,
        captured first if there is none (after an eager warm-up call unless ``warm_up`` is False)."""
        full_key = (key, _signature(inputs))
        prog = self._programs.get(full_key)
        if prog is None:
            with span("compiled.capture"):
                prog = self._programs[full_key] = self._capture(fn, inputs, dev, warm_up)
        self.replays += 1
        self.copies_in += len(inputs)
        return prog.replay(inputs)

    def _capture(self, fn, inputs, dev, warm_up) -> Program:
        t0 = time.perf_counter()
        static = [x.clone() for x in inputs]
        before = launch_counts()
        try:
            with device_scope(dev):
                if warm_up:
                    _warm_up(fn, static, dev)
                warm = launch_counts()
                if dev not in self._pools:
                    self._pools[dev] = _new_pool()
                graph, out = _graph(fn, static, self._pools[dev])
            captured = {k: n - warm[k] for k, n in launch_counts().items() if n != warm[k]}
        finally:
            for k, n in before.items():
                KERNELS[k].launches = n
        prog = Program(fn, graph, static, _flat(out), captured, single=torch.is_tensor(out))
        prog.capture_s = time.perf_counter() - t0
        self.capture_s += prog.capture_s
        return prog


def _signature(inputs) -> tuple:
    return tuple((tuple(x.shape), x.dtype, x.device) for x in inputs)


class Step:
    """One optimisation step, ``fn(*inputs)``, run per call; captured on a CUDA device.

    ``fn`` runs the forward pass, the loss, ``backward()`` and the
    optimiser's update of the state it closes over (parameters, their
    gradients, the optimiser's moments), and returns tensors (the loss).
    ``probe`` is a tensor on the step's device (a parameter).  On a CUDA
    device the first call of an input signature runs ``fn`` eagerly on a
    side stream, as a frame's warm-up does, and returns its outputs: it
    is step 1, and it makes the optimiser's state, which the program then
    updates in place.  The second call captures ``fn`` (a capture records
    the launches without running them) and replays the program, which
    runs step 2; later calls replay.  No call runs ``fn`` twice.  On the
    CPU and under :func:`disabled` every call runs ``fn`` eagerly.

    The graph holds the addresses of the parameters, the optimiser's state
    and the tensors ``fn`` closes over: the state must be made and
    restored (a checkpoint's ``load_state_dict`` replaces its tensors)
    before the first call, and the optimiser must keep its step count on
    the device (``torch.optim.Adam(capturable=True)``).  ``fn`` must not
    read a value back to the host: the caller reads the returned loss.
    The gradients must be ``None`` when the capture starts (``fn`` zeroes
    them with ``set_to_none=True``), so that the program's backward writes
    them rather than adding to them.
    """

    def __init__(self, fn, probe: torch.Tensor):
        self.fn = fn
        self.probe = probe
        self.programs = Programs()
        self._warm: set = set()

    def __call__(self, *inputs):
        if not _captures(self.probe) or _eager.get():
            return self.fn(*inputs)
        dev, sig = self.probe.device, _signature(inputs)
        if sig not in self._warm:
            with device_scope(dev):
                out = _warm_up(self.fn, inputs, dev)
            self._warm.add(sig)
            return out
        return self.programs.replay("step", self.fn, inputs, dev, warm_up=False)


# The capture backend: module functions, so that a test can stand in for the card.


def _captures(x: torch.Tensor) -> bool:
    """Whether calls on ``x``'s device go through captured programs."""
    return x.is_cuda


def _warm_up(fn, static, dev):
    """One eager call on a side stream of ``dev``, its outputs returned: lazy initialisation (the
    kernel library, cuBLAS, module loading, an optimiser's state) happens before the capture, not
    in it."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out = fn(*static)
    torch.cuda.current_stream(dev).wait_stream(side)
    return out


def _new_pool():
    return torch.cuda.graph_pool_handle()


def _graph(fn, static, pool):
    """(graph, outputs): ``fn(*static)`` captured into a new CUDA graph in ``pool``, on a side
    stream of the current device (the inputs').

    The cyclic garbage collector is off during the capture: a dead
    program's graph destroyed inside it frees memory, which a capture
    refuses (the capture fails with ``cudaErrorStreamCaptureInvalidated``).
    """
    graph = torch.cuda.CUDAGraph()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn(*static)
    finally:
        if enabled:
            gc.enable()
    return graph, out
