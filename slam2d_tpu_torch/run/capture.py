"""One chunk of steps captured as a CUDA graph: the protocol shared by
run/frontend.py's ChunkGraph, run/frontend_tiled.py's TiledChunkGraph and
run/fastslam_run.py's PFChunkGraph.

Warm-up steps run first on a side stream (they build the kernels, fill
the cached tables and the allocator), then `torch.cuda.graph` captures
the chunk. A capture launches nothing, while the kernels' wrappers count
every launch they enqueue: the counts a capture made are taken back and
added once a replay instead. A failed build or capture raises.

`ChunkCapture` holds what the three graphs share: a run `load`s its state
into the static buffers, each chunk is `run_chunk` (the chunk's inputs
copied in, one replay, the outputs copied out on the device), and
`finish` clones the state out and adds the replays' counts to the step's
device counters. `chunk_graph_of` keeps one graph per key.

Each of the three is a span of utils/profiling.py with its device marks:
`chunk.load` (`load` before the state's copies), `chunk.replay` (`copied`
after the inputs' copies, `head` recorded by the graph itself at the
head of the captured body, `replayed` after the replay) and
`chunk.finish` (`cloned` after the state's clone). `head` - `copied` is
the device's wait for the graph's submission, `replayed` - `head` the
graph's own run.
"""

from __future__ import annotations

import numpy as np
import torch

from slam2d_tpu_torch.utils import profiling


def capture(device, warm, body, counters):
    """(graph, launches): `warm()` run on a side stream of `device`, then
    `body()` captured as one CUDA graph; `launches` holds a (wrapper,
    count) pair for each wrapper of `counters` (functions with a
    `launches` attribute) that the capture launched."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    before = [fn.launches for fn in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    launches = []
    for fn, b in zip(counters, before):
        if fn.launches != b:
            launches.append((fn, fn.launches - b))
        fn.launches = b
    return graph, launches


def replay(graph, launches):
    """One replay of a captured chunk, its launches counted."""
    graph.replay()
    for fn, n in launches:
        fn.launches += n


def cuda_device(device) -> torch.device:
    """`device` as an indexed CUDA device; any other device raises."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA graphs need a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def use_graph(device, plain, graph) -> bool:
    """Whether a run replays CUDA graphs: by default on CUDA, unless
    `plain`; True insists."""
    on_cuda = torch.device(device).type == "cuda"
    if graph is None:
        return on_cuda and not plain
    if graph and (not on_cuda or plain):
        raise ValueError("graph=True needs a CUDA device and plain=False")
    return graph


def pinned(a) -> torch.Tensor:
    """A pinned float32 host copy of the array `a` (the host allocator
    keeps the block until the copy from it ran); a pinned tensor is
    returned as it is."""
    if isinstance(a, torch.Tensor) and a.is_pinned():
        return a
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).pin_memory()


class ChunkCapture:
    """K steps on static buffers, captured as one CUDA graph. A subclass
    sets `device`, `K`, `state` (a NamedTuple of the state's buffers),
    `inputs` (the buffers `run_chunk` fills, in its argument order),
    `out` (the [K, n] outputs), `counts` (the device counters its steps
    add to) and `step` (the step object whose `counter(device)` takes
    them), then calls `_capture(kernels)`; it supplies `_one(k, state)`,
    step k from `state` with its outputs written into out[k]."""

    WARMUP_STEPS = 3

    def _capture(self, kernels):
        """Warm-up steps, then the K steps captured, with the `head` mark's
        event recorded first; the state the last step returns is copied
        into the buffers where it is not them."""
        self.head = torch.cuda.Event(enable_timing=True, external=True)

        def warm():
            self.head.record()    # made here, outside the capture
            state = self.state
            for k in range(min(self.WARMUP_STEPS, self.K)):
                state = self._one(k, state)

        def body():
            self.head.record()
            state = self.state
            for k in range(self.K):
                state = self._one(k, state)
            for dst, src in zip(self._buffers(self.state),
                                self._buffers(state)):
                if dst is not src:
                    dst.copy_(src)

        self.graph, self.launches = capture(self.device, warm, body, kernels)
        self.counts.zero_()
        self.replays = 0

    def _buffers(self, state):
        """The state's tensors, in the static buffers' order."""
        return tuple(state)

    def _clone(self, state):
        """A copy of `state` that owns its tensors."""
        return type(state)(*(t.clone() for t in state))

    def load(self, state):
        """Copy a run's state into the static buffers (a tensor that is
        the buffer itself is skipped)."""
        with profiling.span("chunk.load"):
            profiling.mark("load", self.device)
            for dst, src in zip(self._buffers(self.state),
                                self._buffers(state)):
                if dst is not src:
                    dst.copy_(src)

    def run_chunk(self, *args):
        """One chunk from the static state: `args` are the chunk's inputs
        in the order of `inputs` (host tensors pinned, or device tensors),
        then `out`. The inputs are copied into the static buffers, the
        graph replays once, and the outputs are copied into `out` on the
        device."""
        *inputs, out = args
        with profiling.span("chunk.replay", scans=self.K):
            for dst, src in zip(self.inputs, inputs):
                dst.copy_(src, non_blocking=True)
            profiling.mark("copied", self.device)
            profiling.mark("head", self.device, self.head)
            replay(self.graph, self.launches)
            profiling.mark("replayed", self.device)
            self.replays += 1
            out.copy_(self.out)

    def flush_counts(self):
        """Add the replays' counts to the step's device counters (no host
        read) and zero the graph's."""
        self.step.counter(self.device).add_(self.counts)
        self.counts.zero_()

    def finish(self):
        """The new state, cloned (a later chunk or run reuses the static
        buffers), and the counts flushed."""
        with profiling.span("chunk.finish"):
            self.flush_counts()
            state = self._clone(self.state)
            profiling.mark("cloned", self.device)
        return state


_GRAPHS: dict = {}


def chunk_graph_of(cls, *key):
    """The cached `cls(*key)`, built on first use (`key` holds the
    constructor's arguments: configs, a torch.device, K)."""
    full = (cls, *key)
    if full not in _GRAPHS:
        _GRAPHS[full] = cls(*key)
    return _GRAPHS[full]
