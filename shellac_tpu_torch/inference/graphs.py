"""The engines' programs as captured CUDA graphs: the port's counterpart
of the JAX package's jitted `lax.scan` windows and per-bucket prefills.

A `StepGraph` wraps one program (`Engine`'s decode step, a batching
engine's window of `decode_ticks` ticks, or its prefill of one bucket
length) that reads and writes only tensors which keep their identity
from call to call. On a CUDA
device its first call runs the program eagerly: a real step, and the
warm-up that capture needs (lazy initialisation, the kernels' one-time
host queries). The second call captures the program, which executes
nothing, then replays it; every later call replays it. On the CPU every
call runs the program eagerly. A capture or replay that fails raises:
there is no eager fallback on the card.

Random numbers: a program that samples draws from a `torch.Generator`
registered with its graph, so each replay draws fresh numbers.

Memory: each graph captures into a private memory pool unless it is
given one to share. Graphs that share a pool may hand each other's
intermediate memory out as their outputs, so a graph's outputs are only
good until another graph of the pool replays: the caller copies them
out (`HostPull`) before the next replay is queued, and stream order does
the rest.

Outputs: a replay overwrites the previous replay's outputs. `HostPull`
copies a program's outputs into pinned host memory on the stream, right
after the replay, and records an event; the host reads them after
waiting on that event, so a later replay cannot reach them and the host
never blocks on work queued after them.

Launch counters: each kernel wrapper counts its launches in Python when
it is called, which a replay does not do. The capture restores every
counter to its value before the capture and records how much each grew;
every replay adds that, so a replayed step counts exactly the launches
the eager step counts.

Threads: a capture refuses CUDA calls that could synchronize, and
destroying a graph is one. So the cyclic collector is paused while a
capture runs, lest it free an abandoned graph in the middle of it
(collecting first, as `torch.cuda.graph` does, would cost every
`generate` call, which captures anew, a walk of the whole heap). The
capture runs in the "thread_local" error mode: only the capturing thread
is held to the rule, so another thread (an HTTP handler) cannot fail it.
No other thread may launch work while a capture runs; the serving
scheduler is the only thread that touches the card.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch


def counted_wrappers():
    """The kernel wrappers whose `launches` counters a replay updates."""
    from shellac_tpu_torch.ops import decode_attention as da
    from shellac_tpu_torch.ops import flash_attention as fa
    from shellac_tpu_torch.ops import norms

    return (norms.rms_norm_cuda, fa.flash_attention_cuda,
            fa.flash_bwd_dkdv_cuda, fa.flash_bwd_dq_cuda,
            da.decode_attention_cuda, da.decode_attention_quant_cuda,
            da.paged_decode_attention_cuda,
            da.paged_decode_attention_quant_cuda)


class StepGraph:
    """A decode program run eagerly once, then captured and replayed (on
    a CUDA device); run eagerly on every call elsewhere. Calling it
    returns the program's outputs, which on the card are the captured
    outputs, overwritten by each replay."""

    # Graphs captured by every StepGraph of the process.
    captures = 0

    def __init__(self, fn: Callable, device: torch.device,
                 generator: Optional[torch.Generator] = None, pool=None):
        self.fn = fn
        self.device = device
        self.generator = generator
        # A memory pool shared with other graphs, or None for a private
        # one (torch.cuda.graph_pool_handle()).
        self.pool = pool
        self.calls = 0
        self.graph = None
        self._out = None
        self._launches = ()

    def __call__(self):
        self.calls += 1
        if self.device.type != "cuda" or self.calls == 1:
            return self.fn()
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for wrapper, n in self._launches:
            wrapper.launches += n
        return self._out

    def _capture(self) -> None:
        wrappers = counted_wrappers()
        before = [w.launches for w in wrappers]
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        pool = (self.pool if self.pool is not None
                else torch.cuda.graph_pool_handle())
        torch.cuda.synchronize(self.device)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(torch.cuda.Stream(self.device)):
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    out = self.fn()
                except BaseException:
                    _abandon(graph, pool, self.device)
                    raise
                graph.capture_end()
            grown = [w.launches - b for w, b in zip(wrappers, before)]
        finally:
            for w, b in zip(wrappers, before):
                w.launches = b
            if collecting:
                gc.enable()
        self.graph, self._out = graph, out
        self._launches = tuple((w, n) for w, n in zip(wrappers, grown) if n)
        StepGraph.captures += 1


def call_captured(runner):
    """Call a program's runner so that on the card this very call replays
    its graph: a StepGraph never called before runs its eager warm-up
    first (the program must be idempotent over its fixed inputs, as the
    beam searches' prefills are). Anything else (a StepGraph on the CPU,
    or a plain function standing in for one) is called once."""
    if (isinstance(runner, StepGraph) and runner.calls == 0
            and runner.device.type == "cuda"):
        runner()
    return runner()


class HostPull:
    """A device tensor's values on their way to the host: on the card a
    copy into pinned memory queued on the current stream behind the
    program that wrote them, and an event after it; on the CPU the
    tensor itself. `get()` waits for the copy (not for later work) and
    returns a numpy array."""

    __slots__ = ("host", "event")

    def __init__(self, t: torch.Tensor):
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t, None

    def get(self):
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _abandon(graph, pool, device: torch.device) -> None:
    """End a capture whose program raised. An invalidated capture makes
    `capture_end` raise before it hands the allocator's routing back, so
    that is done here, and the pool is released; the program's own error
    is the one reported."""
    try:
        graph.capture_end()
        return
    except RuntimeError:
        pass
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    for release in (torch._C._cuda_endAllocateToPool,
                    torch._C._cuda_releasePool):
        try:
            release(index, pool)
        except RuntimeError:
            pass
