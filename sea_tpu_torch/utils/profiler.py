"""Region profiler and named intermediate-buffer registry (eager PyTorch).

The port of `sea_tpu/utils/profiler.py`: nested timed regions building a
call tree, and `register_temp_buffer`, a capture of named intermediates that
tests and `chip_smoke.py` read instead of mocking. PyTorch runs eagerly, so
every registered value is a real tensor. The registry is off by default and
then returns at once.

Region times are host times. On a CUDA device they measure the enqueue, not
the device work, unless `synchronize` is set, which synchronises the device
at each region's start and end, so that a region is charged with its own
device work and not with what was queued before it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional

import torch


class _Region:
    __slots__ = ("name", "total", "count", "children")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.children: Dict[str, "_Region"] = {}


class Benchmark:
    def __init__(self):
        self.disabled = True
        self.synchronize = False
        self.buffers: Dict[str, List[Any]] = {}
        self._root = _Region("root")
        self._stack: List[_Region] = [self._root]

    # --- activation -----------------------------------------------------
    def activate_temp_buffers(self, enabled: bool = True):
        self.disabled = not enabled
        if enabled:
            self.buffers = {}

    def reset(self):
        self.buffers = {}
        self._root = _Region("root")
        self._stack = [self._root]

    # --- buffer registry ------------------------------------------------
    def register_temp_buffer(self, name: str, value, lazy: Optional[Callable] = None):
        if self.disabled:
            return
        if value is None and lazy is not None:
            value = lazy()
        if value is None:
            return
        self.buffers.setdefault(name, []).append(value)

    def get_temp_buffer(self, name: str, index: int = -1):
        return self.buffers[name][index]

    # --- timed regions --------------------------------------------------
    @contextlib.contextmanager
    def region(self, name: str):
        if self.disabled:
            yield
            return
        parent = self._stack[-1]
        node = parent.children.setdefault(name, _Region(name))
        self._stack.append(node)
        if self.synchronize and torch.cuda.is_available():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.synchronize and torch.cuda.is_available():
                torch.cuda.synchronize()
            node.total += time.perf_counter() - t0
            node.count += 1
            self._stack.pop()

    def format_tracetree(self) -> str:
        lines: List[str] = []

        def walk(node: _Region, depth: int, parent_total: float):
            pct = 100.0 * node.total / parent_total if parent_total > 0 else 100.0
            lines.append(
                f"{'  ' * depth}{node.name}: {node.total * 1e3:.2f}ms "
                f"({pct:.1f}%, n={node.count})"
            )
            for c in node.children.values():
                walk(c, depth + 1, node.total)

        total = sum(c.total for c in self._root.children.values())
        for c in self._root.children.values():
            walk(c, 0, total)
        return "\n".join(lines)


_BENCH = Benchmark()


def get_bench() -> Benchmark:
    return _BENCH


def region(name: str):
    """`get_bench().region(name)`."""
    return _BENCH.region(name)


def register_temp_buffer(name: str, value, lazy: Optional[Callable] = None):
    """`get_bench().register_temp_buffer(...)`."""
    _BENCH.register_temp_buffer(name, value, lazy)
