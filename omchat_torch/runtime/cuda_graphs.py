"""One CUDA graph per decode step or roll: the port's counterpart of a JAX
jit dispatch.

The decode step issues some 15 launches a layer over 28 layers, plus the
lm_head and the argmax; issued one by one from Python the host takes two to
three times the card's time for them.  A :class:`GraphedStep` runs a step's
body (a callable without arguments that reads and writes only buffers that
outlive it: the cache or page pools, the params and the engine's static
token / length buffers) eagerly once, on a side stream, so that every
kernel library is loaded (``ops.kernel_lib.library``), every
``cudaFuncSetAttribute`` has run and cuBLAS has its workspace, and then
captures it into a CUDA graph; every later call replays the graph, one
launch from the host for the whole step.  The eager run is a real step: its
results are the step's, so the first call of a body computes what every
call computes.

The graph bakes in every address it touched.  Copying new values into the
static buffers between replays is what the callers do; rebinding them
would leave the graph reading the old memory.  What a body allocates while
it is captured (the split-KV scratch of K3, K12 and K13, the weight-only
int8 decode's bf16 weight copies, the intermediates) comes from the graph's
memory pool.  An engine shares one pool (``torch.cuda.graph_pool_handle``)
among all its graphs, which is safe because no tensor allocated during a
capture is read after another graph has been replayed: the bodies leave
their results in static buffers allocated outside every capture.

Launch counters (``<wrapper>.launches`` of every kernel wrapper in the
modules of ``omchat_torch.ops``) would count the capture, which runs
nothing, and miss every replay.  So the capture's count is taken back and
recorded, and each replay adds it again: the counters read what the card
ran.  The capture's count must equal the eager first run's, wrapper by
wrapper, or the capture raises.  A failure of capture or replay raises;
nothing falls back to the eager route.

A body that draws random numbers (a sampled decode step) names its
generators: each is registered with the graph
(``CUDAGraph.register_generator_state``), so that every replay draws from
the generator's current seed and offset and advances the offset by what the
captured draws consume, as the eager body does.  The offset the eager first
run advanced is recorded, and the first replay must advance it by as much,
or it raises: the graph's draws are the eager body's.

A capture runs with Python's cyclic garbage collector paused and in
``thread_local`` capture mode: a collection inside the capture would run the
finalizers of earlier engines' garbage (their graphs, pools, pinned host
buffers), whose CUDA calls invalidate a capture in progress (a roll's GEMM
then fails with ``CUBLAS_STATUS_EXECUTION_FAILED``), and another thread's
calls may not invalidate it either.
"""

from __future__ import annotations

import gc
import importlib
import pkgutil
import time
from typing import Callable, Dict, Optional, Sequence

import torch


def counted_wrappers() -> list:
    """Every kernel wrapper in the modules of ``omchat_torch.ops`` that counts
    its launches."""
    import omchat_torch.ops as ops

    found = []
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        for obj in vars(mod).values():
            if callable(obj) and isinstance(getattr(obj, "launches", None), int) and obj not in found:
                found.append(obj)
    return found


class GraphedStep:
    """``body`` run eagerly on its first call, then captured into a CUDA
    graph in ``pool``; every later call replays it.  Each call runs the body
    once on the card and returns what the body returns (the captured run's
    result from the second call on: the body should return its static
    output buffers).  ``capture_s`` is the wall time the capture took.
    ``generators``: the CUDA generators the body draws from."""

    def __init__(self, body: Callable[[], object], pool, device: torch.device,
                 generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.pool = pool
        self.device = device
        self.generators = tuple(generators)
        self._draws: Optional[list] = None  # offsets the eager run advanced, until the first replay checks them
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out = None
        self.capture_s = 0.0
        self.replays = 0
        self._deltas: Dict[Callable, int] = {}

    def __call__(self):
        if self.graph is None:
            return self._run_and_capture()
        before = [g.get_offset() for g in self.generators] if self._draws is not None else None
        self.graph.replay()
        if before is not None:
            replayed = [g.get_offset() - b for g, b in zip(self.generators, before)]
            if replayed != self._draws:
                raise RuntimeError(f"GraphedStep: a replay advanced its generators by {replayed}, the eager run "
                                   f"by {self._draws}")
            self._draws = None
        for wrapper, n in self._deltas.items():
            wrapper.launches += n
        self.replays += 1
        return self.out

    def _run_and_capture(self):
        wrappers = counted_wrappers()
        before = {w: w.launches for w in wrappers}
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        offsets = [g.get_offset() for g in self.generators]
        with torch.cuda.stream(side):
            out = self.body()
        current.wait_stream(side)
        torch.cuda.synchronize(self.device)
        eager = {w: w.launches - before[w] for w in wrappers if w.launches != before[w]}
        draws = [g.get_offset() - o for g, o in zip(self.generators, offsets)]
        before = {w: w.launches for w in wrappers}
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        collecting = gc.isenabled()
        gc.disable()  # garbage waits until the capture has ended (see the module's note)
        try:
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                captured = self.body()
        finally:
            if collecting:
                gc.enable()
            self._deltas = {w: w.launches - before[w] for w in wrappers if w.launches != before[w]}
            for w in wrappers:
                w.launches = before[w]
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        if self._deltas != eager:
            names = lambda d: {w.__name__: n for w, n in d.items()}  # noqa: E731
            raise RuntimeError(f"GraphedStep: the capture launched {names(self._deltas)}, "
                               f"the eager run {names(eager)}")
        self.graph, self.out = graph, captured
        self._draws = draws if self.generators else None
        return out
