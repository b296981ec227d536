"""Task-program builder: compose a megakernel from named tasks.

Counterpart of triton_dist_tpu/mega/builder.py (`Task`,
`MegaKernelBuilder`), copied so that the port does not import the JAX
package. Tasks are recorded with the buffers they read and write; the
builder validates the read-after-write chain as each task is added, so a
misordered program fails at construction.

In the port the recorded order is used twice: the plain version of a
megakernel layer runs the tasks' emitters (PyTorch closures over an env
dict) in that order, and the CUDA kernel runs its barrier-separated
phases in that order (the layer passes the phase codes of its tasks, in
recorded order, to the launch).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple


@dataclasses.dataclass
class Task:
    name: str
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    emit: Callable          # emit(env: dict[str, tensor]) -> None


class MegaKernelBuilder:
    """Record named intermediate buffers and tasks; validate
    dependencies; produce the ordered task list a layer runs."""

    def __init__(self):
        self._buffers: Dict[str, Tuple[Tuple[int, ...], object]] = {}
        self._tasks: List[Task] = []
        self._written: set = set()

    def buffer(self, name: str, shape: Tuple[int, ...], dtype) -> str:
        """Declare an intermediate the tasks pass between them."""
        if name in self._buffers:
            raise ValueError(f"buffer {name!r} already declared")
        self._buffers[name] = (tuple(shape), dtype)
        return name

    def inputs(self, *names: str) -> None:
        """Mark buffers produced outside the kernel (kernel operands)."""
        self._written.update(names)

    def add_task(self, name: str, emit: Callable, *,
                 reads: Sequence[str] = (),
                 writes: Sequence[str] = ()) -> None:
        known = set(self._buffers) | self._written
        for nm in (*reads, *writes):
            if nm not in known:
                raise ValueError(
                    f"task {name!r} references undeclared name {nm!r} "
                    "(declare it with buffer()/inputs())")
        for r in reads:
            if r not in self._written:
                raise ValueError(
                    f"task {name!r} reads {r!r} before any task wrote it "
                    "(a misordered program)")
        self._written.update(writes)
        self._tasks.append(Task(name=name, reads=tuple(reads),
                                writes=tuple(writes), emit=emit))

    @property
    def buffers(self) -> Dict[str, Tuple[Tuple[int, ...], object]]:
        return dict(self._buffers)

    @property
    def tasks(self) -> List[Task]:
        return list(self._tasks)

    def emit_all(self, env: Dict[str, object]) -> None:
        """Run every task's emitter in schedule order."""
        for t in self._tasks:
            t.emit(env)

    def emit_lockstep(self, envs: Sequence[Dict[str, object]]) -> None:
        """Run every task's emitter in schedule order over the ranks of a
        tensor-parallel layer, one env a rank: a task runs on every rank
        before the next task runs on any, so a task that reads the peers'
        buffers (an all-reduce section) finds them written."""
        for t in self._tasks:
            for env in envs:
                t.emit(env)
