"""The traced window, read from torch.profiler's raw events.

``Trace.from_profiler`` keeps, from the profiler's own timeline:

* every device activity (a kernel, a copy or a memset) with its start, its
  end and the host operator that launched it (CUPTI's correlation links a
  device activity to the innermost operator around its launch, ctypes
  launches included);
* every host operator (``aten::*``, ``riptrm::*``) of the thread that ran
  the window, with the operator it ran inside.

The per-layer metrics read these lists; nothing here knows a metric.
"""

from __future__ import annotations

import dataclasses

COPY_PREFIXES = ("Memcpy", "Memset")


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start: float  # seconds since the trace's start
    end: float
    op: int  # correlation id of the launching host operator, 0 if unknown

    @property
    def is_copy(self) -> bool:
        return self.name.startswith(COPY_PREFIXES)


@dataclasses.dataclass
class HostOp:
    name: str
    start: float
    end: float
    parent: int  # correlation id of the enclosing operator, 0 at the top


@dataclasses.dataclass
class Trace:
    device: list  # DeviceEvent, sorted by start
    ops: dict  # correlation id -> HostOp, the window's thread only

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        results = prof.profiler.kineto_results
        t0 = results.trace_start_ns()
        device, host = [], []
        for ev in results.events():
            if ev.is_hidden_event():
                continue
            start, end = (ev.start_ns() - t0) * 1e-9, (ev.end_ns() - t0) * 1e-9
            if ev.device_type() == DeviceType.CUDA:
                device.append(DeviceEvent(ev.name(), start, end, ev.linked_correlation_id()))
            elif (ev.device_type() == DeviceType.CPU and ev.linked_correlation_id() == 0
                  and ev.correlation_id() > 0):
                host.append((ev.start_thread_id(), start, end, ev.correlation_id(), ev.name()))
        device.sort(key=lambda e: e.start)
        return cls(device, _nest(host))

    # -- device time -----------------------------------------------------
    def busy_s(self) -> float:
        """Seconds in which some device activity ran: the union of the
        device intervals."""
        return sum(end - start for start, end in self.merged())

    def merged(self):
        """The device intervals merged into disjoint (start, end) pairs."""
        out = []
        for ev in self.device:
            if out and ev.start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], ev.end)
            else:
                out.append([ev.start, ev.end])
        return out

    def kernels(self):
        return [ev for ev in self.device if not ev.is_copy]

    def ancestors(self, op: int):
        """Names of operator ``op`` and of every operator it ran inside."""
        seen = set()
        while op in self.ops and op not in seen:
            seen.add(op)
            yield self.ops[op].name
            op = self.ops[op].parent

    def device_s_under(self, match) -> float:
        """Device seconds of the activities launched inside an operator
        whose name satisfies ``match``."""
        return sum(ev.end - ev.start for ev in self.device
                   if any(match(name) for name in self.ancestors(ev.op)))

    # -- breakdown ---------------------------------------------------------
    def top_device_ops(self, count=10):
        by_name = {}
        for ev in self.device:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + (ev.end - ev.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[_short(name), seconds] for name, seconds in top]

    def idle_by_host_op(self, count=10):
        """The device's idle gaps inside the traced span, summed by the
        innermost host operator running at each gap's midpoint ("python"
        where none ran: the interpreter between operators)."""
        merged = self.merged()
        ops = sorted(self.ops.values(), key=lambda op: (op.start, -op.end))
        by_name, stack, i = {}, [], 0
        # gaps come in time order: a stack of the operators open at each
        # gap's midpoint, innermost on top (operators of one thread nest)
        for (_, a), (b, _) in zip(merged, merged[1:]):
            mid = 0.5 * (a + b)
            while i < len(ops) and ops[i].start <= mid:
                while stack and stack[-1].end < ops[i].start:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1].end < mid:
                stack.pop()
            name = stack[-1].name if stack else "python"
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:count]
        return [[_short(name), seconds] for name, seconds in top]


def _short(name: str, limit: int = 160) -> str:
    return name if len(name) <= limit else name[: limit - 3] + "..."


def _nest(host):
    """Host operators of the busiest thread, each with its parent: on one
    thread operators nest, so a stack over them sorted by (start, -end)
    gives each its innermost enclosing operator."""
    counts = {}
    for tid, *_ in host:
        counts[tid] = counts.get(tid, 0) + 1
    if not counts:
        return {}
    main = max(counts, key=counts.get)
    rows = sorted((r for r in host if r[0] == main), key=lambda r: (r[1], -r[2]))
    ops, stack = {}, []
    for _, start, end, corr, name in rows:
        if corr in ops:  # ids are unique; a repeated one is not an operator
            continue
        while stack and ops[stack[-1]].end < start:
            stack.pop()
        ops[corr] = HostOp(name, start, end, stack[-1] if stack else 0)
        stack.append(corr)
    return ops
