"""Fixed-length solver segments, eager or replayed from CUDA graphs.

The reference runs a whole Krylov solve as one ``lax.while_loop`` program,
with no host sync at all.  Torch has no device-side loop, so the port runs
a solve as a host loop over *segments* of a fixed number of iterations:
inside a segment every iteration computes the loop body and keeps its
result only where the loop condition held (a device-side flag), so the
carry freezes once the condition fails, as the ``while_loop`` would leave
it.  After each segment the host reads one flag, whether the condition
still holds: one host sync per segment, the port's one deviation from the
reference's zero-sync loop.

``SegmentRunner`` drives one such segment function ``seg(*state) ->
(state', flag)``.  On CPU tensors, with ``graph=False``, or when the
segment calls a ``Comm``'s collectives (the distributed solvers: gloo
stages every payload through the host, which a graph cannot capture), it
calls ``seg`` eagerly.  On CUDA tensors it captures ``seg`` once into a
``torch.cuda.CUDAGraph`` over static state buffers -- the graph ends by
copying the new state into those buffers, so each replay advances the
solve in place -- after one warm-up segment on a side stream, which builds
and loads the kernels outside the capture.  Captured programs are cached
by a key the solver gives (its name, the callables the segment closes
over, its static arguments) and the state's shapes and dtypes: a second
solve with the same operator and shapes replays without capturing.  A
program lives as long as its operator (the first of those callables, held
weakly): its graph, its static buffers and its memory pool go with the
operator, and a solve with a fresh operator (a new closure or lambda)
leaves nothing behind.  A failed capture raises; nothing carries on
eagerly in its place.

The kernel wrappers count their calls, and so count the calls made while
a graph is captured, which record a launch and run nothing; each replay
runs the captured kernels again without the wrappers.  The runner tallies
both, per kernel and per ``"kernel/route"``: ``CAPTURED_LAUNCHES`` at each
capture and ``REPLAYED_LAUNCHES`` at each replay, so the launches that
ran are the wrappers' counts less the first plus the second.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs import trace

#: flags read by the host (one per segment run through ``step``)
HOST_SYNCS = 0
#: kernel calls recorded into graphs at capture, and kernel launches made
#: by graph replays, per kernel and per "kernel/route" (module docstring)
CAPTURED_LAUNCHES: Dict[str, int] = defaultdict(int)
REPLAYED_LAUNCHES: Dict[str, int] = defaultdict(int)


def launch_tally() -> Dict[str, int]:
    """The wrappers' counts, per kernel and per ``"kernel/route"``."""
    flat = dict(kops.launch_counts())
    for name, routes in kops.route_launch_counts().items():
        flat.update({f"{name}/{r}": n for r, n in routes.items()})
    return flat


@dataclasses.dataclass
class _Program:
    graph: "torch.cuda.CUDAGraph"
    static: Tuple[torch.Tensor, ...]
    flag: torch.Tensor
    launches: Dict[str, int]


#: operator -> {the rest of the key: program}
_PROGRAMS: "weakref.WeakKeyDictionary[Callable, Dict[tuple, _Program]]" = \
    weakref.WeakKeyDictionary()


def _capture(seg: Callable, state: Sequence[torch.Tensor]) -> _Program:
    if trace.timing_active():
        raise RuntimeError("a solver segment cannot be captured while "
                           "phase_times or phase_events is active; time an "
                           "eager segment (graph=False) instead")
    dev = state[0].device
    static = tuple(t.clone() for t in state)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        seg(*static)                      # warm-up: builds/loads kernels
    torch.cuda.current_stream(dev).wait_stream(side)
    before = launch_tally()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out, flag = seg(*static)
        for s, o in zip(static, out):
            if o is not s:
                s.copy_(o)
    launches = {k: v - before[k] for k, v in launch_tally().items()}
    for k, n in launches.items():
        CAPTURED_LAUNCHES[k] += n
    return _Program(g, static, flag, launches)


class SegmentRunner:
    """Run segments of ``seg`` from ``state`` (see module docstring).

    ``key``: ``(name, callables, static arguments)`` -- every value the
    segment closes over besides the state, the operator first (its
    captured programs live as long as it does); ``counter[name]`` is
    incremented at each capture.  ``graph=None`` captures on CUDA tensors and runs
    eagerly on CPU tensors; ``graph=True`` on CPU tensors raises.
    ``collectives``: the segment calls a ``Comm``'s collectives, which gloo
    stages through the host: it runs eagerly, and ``graph=True`` raises.
    """

    def __init__(self, key: tuple, seg: Callable,
                 state: Sequence[torch.Tensor], graph: Optional[bool],
                 counter: Dict[str, int], collectives: bool = False):
        on_card = state[0].is_cuda
        if graph and collectives:
            raise ValueError("graph=True: a segment with collectives cannot "
                             "be captured into a CUDA graph (gloo stages "
                             "its payloads through the host)")
        if graph is None:
            graph = on_card and not collectives
        if graph and not on_card:
            raise ValueError("graph=True needs CUDA tensors")
        self.seg, self.graph = seg, bool(graph)
        if not self.graph:
            self.state = tuple(state)
            return
        name, (op, *fns), args = key
        rest = (name, tuple(fns), tuple(args),
                tuple((tuple(t.shape), t.dtype, t.device) for t in state))
        programs = _PROGRAMS.setdefault(op, {})
        prog = programs.get(rest)
        if prog is None:
            prog = _capture(seg, state)
            programs[rest] = prog
            counter[name] += 1
        for s, t in zip(prog.static, state):
            s.copy_(t)
        self.prog = prog
        self.state = prog.static

    def run(self) -> torch.Tensor:
        """One segment; returns the flag tensor without reading it."""
        if self.graph:
            self.prog.graph.replay()
            for k, n in self.prog.launches.items():
                REPLAYED_LAUNCHES[k] += n
            return self.prog.flag
        self.state, flag = self.seg(*self.state)
        return flag

    def step(self) -> bool:
        """One segment, then the host reads its flag (one sync): whether
        the solver's loop condition still holds."""
        global HOST_SYNCS
        flag = self.run()
        HOST_SYNCS += 1
        return bool(flag)

    def result(self) -> Tuple[torch.Tensor, ...]:
        """The current state (copies of the static buffers on the graph
        path, which the next run of the program overwrites)."""
        if self.graph:
            return tuple(t.clone() for t in self.state)
        return self.state
