"""A render call as one device program: the machinery that the regen and
the bounce integrators share (the counterpart of the JAX package's
`lax.while_loop` under `jax.jit`).

A call is a run of fixed-shape steps (a regen wave; a frame start, a
bounce, a frame end) that keep every count on the device and read nothing
on the host, each writing its outputs into the call's own state tensors.
On a CUDA device each step is captured once as a CUDA graph (`StepGraph`,
through `capture`) and replayed; the CPU runs the same steps eagerly, and
so does the card inside `no_graphs()`, the counterpart of
`jax.disable_jit()`.

The host learns where a call stands from a status (a device int64 [done,
count, left]) that a step writes: after each step it is copied without
blocking into a ring of LAG + 1 host tensors (`StatusRing`, pinned memory
with an event each on the card), and the host reads a step's status only
LAG steps later, so LAG steps are in flight and LAG - 1 steps run past
the end. A step past the end must be an exact no-op.

A call's host side is a generator (`drive` runs the steps of one loop):
each next() launches one step and may first wait for a status LAG steps
old. `run_calls` steps several calls in turn, one step of each device's
current call a turn, so the calls of different devices are in flight
together; calls on one device run one after another (they may share that
device's captured graph and its state). `run_call` is the single call.
"""
from __future__ import annotations

import contextlib
import time

import torch

# steps in flight: the host launches step i once it has seen the status of
# step i - LAG
LAG = 2
WARMUP_STEPS = 3      # eager steps on a side stream before a capture
# what a ring slot holds before its step's status lands: not done, a count
# that no call reaches, the queue not spent
_UNSEEN = (0, 1 << 62, 1)
_NO_GRAPHS = [0]
# one memory pool a device for every captured step: a step keeps its whole
# state in tensors allocated outside the capture, so what it allocates
# inside is dead when its replay ends, and the replays of one device follow
# one another on its stream
_POOLS = {}


@contextlib.contextmanager
def no_graphs():
    """Inside the block every render runs its steps eagerly, one kernel
    launch after another, on the card as on the CPU: the counterpart of
    `jax.disable_jit()`. The steps and the image are the same; only the
    dispatch differs."""
    _NO_GRAPHS[0] += 1
    try:
        yield
    finally:
        _NO_GRAPHS[0] -= 1


def graphs_enabled(device):
    """Whether a render on `device` replays captured steps: on a CUDA
    device outside no_graphs()."""
    return torch.device(device).type == "cuda" and not _NO_GRAPHS[0]


def _count_tables():
    """The launch counts a step's kernels add to: the traversal's
    (ops.traverse_packet.LAUNCHES, FORM_LAUNCHES), the shade kernel's
    (ops.shade.LAUNCHES), the surface fetches'
    (ops.surface_fetch.LAUNCHES), the pool gather's (ops.permute.LAUNCHES)
    and the BSSRDF probe loop's (ops.bssrdf.LAUNCHES)."""
    from ..ops import bssrdf, permute, shade, surface_fetch
    from ..ops import traverse_packet as tp
    return tp.LAUNCHES, tp.FORM_LAUNCHES, shade.LAUNCHES, \
        surface_fetch.LAUNCHES, permute.LAUNCHES, bssrdf.LAUNCHES


def launch_counts():
    return {k: v for table in _count_tables() for k, v in table.items()}


def set_launch_counts(counts):
    for table in _count_tables():
        for k in table:
            table[k] = counts[k]


def add_launches(launches):
    """Add the per-step launches recorded at a capture to the launch
    counts (_count_tables)."""
    for table in _count_tables():
        for k in table:
            table[k] += launches.get(k, 0)


def capture(step, device):
    """Run step() WARMUP_STEPS times on a side stream, then capture one
    call of it as a CUDA graph. Returns (graph, launches): the kernel
    launches that one call counts (launch_counts()), which
    every replay adds again. The warm-up and the capture are set-up: the
    launch counts are left as they were before them."""
    saved = launch_counts()
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        pool = _POOLS.setdefault(str(device), torch.cuda.graph_pool_handle())
        before = launch_counts()
        with torch.cuda.graph(graph, pool=pool):
            step()
    after = launch_counts()
    set_launch_counts(saved)
    return graph, {k: after[k] - before[k] for k in after
                   if after[k] != before[k]}


class StepGraph:
    """A call's steps ({name: step}) captured on a device, each once, with
    the state `st` they work on (the graphs' static tensors), the status
    ring of the calls that replay them, and the tensors `keep` (the scene)
    that the graphs read, kept alive."""

    def __init__(self, st, steps, device, keep=None):
        self.st, self.keep = st, keep
        self.graphs, self.launches, self.capture_s = {}, {}, 0.0
        for name, step in steps.items():
            t0 = time.perf_counter()
            self.graphs[name], self.launches[name] = capture(step, device)
            self.capture_s += time.perf_counter() - t0
        self.ring = StatusRing(device)

    def steps(self):
        """{name: replay}: each replay adds its step's launches."""
        def replay(name):
            def run():
                self.graphs[name].replay()
                add_launches(self.launches[name])
            return run
        return {name: replay(name) for name in self.graphs}


class StatusRing:
    """LAG + 1 host copies of a call's status: pinned with an event each on
    a CUDA device, plain (events None) on the CPU. post(i, status) copies
    step i's status without blocking and marks it with an event recorded
    on the stream of the status's device; read(i) waits for that event and
    returns the status as a list."""

    def __init__(self, device):
        cuda = torch.device(device).type == "cuda"
        self.flags = [torch.zeros((3,), dtype=torch.int64, pin_memory=cuda)
                      for _ in range(LAG + 1)]
        self.events = ([torch.cuda.Event() for _ in range(LAG + 1)]
                       if cuda else None)

    def reset(self):
        """Start a call: every slot reads _UNSEEN, so a slot that still
        holds an earlier call's status is never read as this call's."""
        unseen = torch.tensor(_UNSEEN, dtype=torch.int64)
        for f in self.flags:
            f.copy_(unseen)

    def post(self, i, status):
        j = i % (LAG + 1)
        self.flags[j].copy_(status, non_blocking=True)
        if self.events is not None:
            self.events[j].record(torch.cuda.current_stream(status.device))

    def read(self, i):
        j = i % (LAG + 1)
        if self.events is not None:
            self.events[j].synchronize()
        return self.flags[j].tolist()


def drive(launch, status, ring, limit=None):
    """Generator: launch steps until a status LAG steps old reads done, or
    `limit` steps. launch(seen) runs one step, given the status of the
    step LAG before it (None for the first LAG steps); the step writes
    `status`, which is posted to `ring`. Yields after each launch and
    returns the number of steps launched. The ring is not reset here: a
    call resets it once, and a slot is read only after its event, recorded
    after this loop's copy into it."""
    i = 0
    while limit is None or i < limit:
        seen = None
        if i >= LAG:
            seen = ring.read(i - LAG)
            if seen[0]:
                break
        launch(seen)
        ring.post(i, status)
        i += 1
        yield
    return i


def run_calls(calls):
    """Run render calls to their ends, stepping them in turn. calls: [(device,
    generator)], each generator launching one step a next() and returning
    the call's result. The calls of one device run one after another, in
    order; the devices take turns, one step of each device's current call
    a turn, under that device's guard, so each device's first LAG steps
    are launched before the host waits on any status. Returns the results
    in the order of `calls`."""
    queues = {}
    for k, (device, call) in enumerate(calls):
        queues.setdefault(torch.device(device), []).append((k, call))
    results = [None] * len(calls)
    while queues:
        for device in list(queues):
            k, call = queues[device][0]
            # a call's streams, events and captures are its device's,
            # whatever device is current
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                try:
                    next(call)
                    continue
                except StopIteration as end:
                    results[k] = end.value
            queues[device].pop(0)
            if not queues[device]:
                del queues[device]
    return results


def run_call(device, call):
    """One render call on `device`, run to its end."""
    return run_calls([(device, call)])[0]


def capture_key(N, device, scene):
    """What a captured step depends on besides the integrator's settings
    and flags: the device, the lanes N of the call's image slice, torch's
    deterministic mode (index_add_ takes another path under it) and the
    identity of the scene's tensors (the graph reads their addresses)."""
    import torch.utils.deterministic as tud
    return (str(torch.device(device)), int(N),
            torch.are_deterministic_algorithms_enabled(),
            bool(tud.fill_uninitialized_memory),
            tuple((k, ("tensor", id(v)) if isinstance(v, torch.Tensor)
                   else repr(v)) for k, v in sorted(scene.items())))
