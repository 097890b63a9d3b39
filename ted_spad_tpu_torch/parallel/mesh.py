"""The data-parallel group: the port's counterpart of the JAX package's 1-D ``data``
mesh (ted_spad_tpu/parallel/mesh.py).

Under JAX a step jitted with ``P('data')`` batches computes its single-device step:
GSPMD turns every reduction over the batch axis into a collective. The port keeps
those semantics by hand, with one process per card:

- rows: each rank holds the contiguous block of a global batch that ``P('data')``
  gives its device (``row_index``); a step that runs ``parts`` microbatches holds its
  block of each microbatch instead, so microbatch i is still the global rows
  ``[i B / parts, (i + 1) B / parts)``;
- the model: inside ``active(mesh)`` train-mode BatchNorm takes global batch
  statistics and dropout draws the global mask and keeps its rows
  (models/layers.py);
- the loss: the step gathers its outputs over the ranks in global order
  (``gather_rows``, differentiable) and every rank computes the one-process loss;
- the gradient: the gather's backward sums the ranks' gradients (reduce-scatter), so
  each rank's parameter gradient is W times its rows' share; ``all_reduce_grads``
  averages them into the one-process gradient on every rank;
- parameters, buffers and optimizer states start equal (``replicate``) and stay equal.

Models are not wrapped in ``DistributedDataParallel``: the steps call methods besides
``forward`` and hold frozen models, and the explicit average after
``zero_missing_grads`` fills the same ``.grad``s on every rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ted_spad_tpu_torch.parallel import multihost

# The mesh and microbatch layout the model code reads inside ``active``: a plain
# module global, not a thread-local, because the autograd engine recomputes a
# checkpointed CUDA forward on its own thread.
_ACTIVE: tuple["DataParallelMesh", int] | None = None


@dataclasses.dataclass(eq=False)
class DataParallelMesh:
    """World size, rank, device and backend of the data-parallel process group (the
    default group, which the step's collectives use), and those collectives.
    ``host_group`` (gloo) carries the input pipeline's host exchanges and the
    barriers, apart from the step's collectives."""

    world_size: int
    rank: int
    device: torch.device
    backend: str
    host_group: Any = None

    # -- rows -------------------------------------------------------------------

    def divides(self, n: int, parts: int = 1) -> bool:
        """Whether a global batch of ``n`` rows shards evenly (per microbatch)."""
        return n > 0 and n % (parts * self.world_size) == 0

    def row_index(self, n: int, parts: int = 1, rank: int | None = None) -> np.ndarray:
        """This rank's (or ``rank``'s) rows of a global batch of ``n``, in its local
        order: the contiguous block ``P('data')`` gives it, or with ``parts``
        microbatches its block of each microbatch, microbatch by microbatch."""
        if not self.divides(n, parts):
            raise ValueError(f"batch {n} does not shard over {self.world_size} ranks "
                             f"x {parts} microbatches")
        m = n // (parts * self.world_size)
        r = self.rank if rank is None else rank
        return (np.arange(parts)[:, None] * (n // parts) + r * m
                + np.arange(m)[None, :]).reshape(-1)

    def shard_rows(self, n: int) -> slice:
        """This rank's contiguous block of a global batch of ``n`` rows."""
        idx = self.row_index(n)
        return slice(int(idx[0]), int(idx[-1]) + 1)

    def take_rows(self, x: Any, n: int | None = None, parts: int = 1) -> Any:
        """This rank's rows of ``x`` (an array, a tensor, or a dataclass / tuple of
        them) whose leading axis holds ``n`` items (default: its length), each item
        ``len(x) / n`` consecutive rows (a clip's views or frames)."""
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{f.name: self.take_rows(getattr(x, f.name), n, parts)
                                             for f in dataclasses.fields(x)})
        if isinstance(x, (tuple, list)):
            return type(x)(self.take_rows(v, n, parts) for v in x)
        if x is None:
            return None
        n = len(x) if n is None else n
        per = len(x) // n
        idx = (self.row_index(n, parts)[:, None] * per + np.arange(per)).reshape(-1)
        if isinstance(x, torch.Tensor):
            return x[torch.as_tensor(idx, device=x.device)]
        return x[idx]

    # -- collectives of a step ---------------------------------------------------

    def gather_rows(self, x: torch.Tensor, dim: int = 0, parts: int = 1) -> torch.Tensor:
        """The global tensor of which every rank holds its rows along ``dim``, in
        global order, differentiable: the backward sums the ranks' gradients and
        hands each rank its block (a reduce-scatter, as an all-reduce, which every
        backend has for CPU and CUDA tensors)."""
        out = _GatherRows.apply(x.movedim(dim, 0), self)
        if parts > 1:  # (rank, part, row) -> (part, rank, row)
            w, rest = self.world_size, out.shape[1:]
            out = out.reshape((w, parts, -1) + rest).transpose(0, 1).reshape((-1,) + rest)
        return out.movedim(0, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, differentiable: the backward sums the ranks' gradients
        too (torch.distributed.nn.functional.all_reduce's rule)."""
        return _AllReduce.apply(x, self)

    def all_reduce_grads(self, params: Iterable[torch.nn.Parameter]) -> None:
        """Average the parameters' ``.grad`` over the ranks, in one coalesced
        all-reduce per dtype (parameters without one are left so)."""
        grads = [q.grad for q in params if q.grad is not None]
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for g in grads:
            by_dtype.setdefault(g.dtype, []).append(g)
        for group in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat)
            flat.div_(self.world_size)
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' tensors concatenated on the leading axis in rank order (no
        gradient)."""
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts)

    def replicate(self, *objs: torch.nn.Module | torch.optim.Optimizer) -> None:
        """Rank 0's parameters and buffers (modules) and state tensors (optimizers)
        broadcast to every rank, in place."""
        for obj in objs:
            if isinstance(obj, torch.nn.Module):
                tensors = list(obj.parameters()) + list(obj.buffers())
            else:
                tensors = [v for state in obj.state.values() for v in state.values()
                           if isinstance(v, torch.Tensor)]
            with torch.no_grad():
                for t in tensors:
                    buf = t.detach().contiguous()
                    if self.backend == "nccl" and buf.device.type == "cpu":
                        buf = buf.to(self.device)  # e.g. Adam's step count
                    dist.broadcast(buf, src=0)
                    if buf.data_ptr() != t.data_ptr():
                        t.copy_(buf)

    # -- host side ---------------------------------------------------------------

    def exchange(self, obj: Any) -> list[Any]:
        """Every rank's picklable ``obj``, in rank order (over the host group)."""
        out: list[Any] = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_group)
        return out

    def unshard_rows(self, local: Any, n: int, parts: int = 1) -> Any:
        """The global host value (an array, or a dataclass of arrays) of which every
        rank holds ``row_index(n, parts)``'s items, each ``len / (n / W)`` rows: the
        inverse of ``take_rows``."""
        return self._assemble(self.exchange(local), n, parts)

    def _assemble(self, pieces: list, n: int, parts: int) -> Any:
        first = pieces[0]
        if first is None:
            return None
        if dataclasses.is_dataclass(first):
            return dataclasses.replace(first, **{
                f.name: self._assemble([getattr(q, f.name) for q in pieces], n, parts)
                for f in dataclasses.fields(first)})
        out = np.empty((len(first) * self.world_size,) + first.shape[1:], first.dtype)
        per = len(out) // n
        for r, piece in enumerate(pieces):
            idx = self.row_index(n, parts, rank=r)
            out[(idx[:, None] * per + np.arange(per)).reshape(-1)] = piece
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
        ctx.mesh = mesh
        out = x.contiguous().clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataParallelMesh) -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        return mesh.gather(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad[mesh.rank * ctx.rows:(mesh.rank + 1) * ctx.rows], None


def data_parallel_mesh(device: str | torch.device | None = None) -> DataParallelMesh:
    """The mesh of the joined process group (``multihost.initialize_distributed`` or
    ``initialize_single`` first); its device is ``cuda:LOCAL_RANK`` for NCCL, else
    ``device`` (default: the card with a CUDA build, the CPU without). Every rank
    must call it: it creates the host group collectively."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize_distributed() first")
    backend = str(dist.get_backend())
    if device is None:
        device = (multihost.local_device("cuda") if backend == "nccl" or torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = multihost.local_device("cuda")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    # Its own group even under gloo: the input pipeline's producer thread exchanges on
    # it while the main thread's step runs collectives on the default group.
    host = dist.new_group(backend="gloo")
    multihost.set_host_group(host)
    return DataParallelMesh(dist.get_world_size(), dist.get_rank(), device, backend,
                            host_group=host)


@contextlib.contextmanager
def active(mesh: DataParallelMesh | None, parts: int = 1):
    """Inside the block train-mode BatchNorm and dropout see the global batch of
    ``mesh`` (laid out in ``parts`` microbatches); with ``mesh=None`` nothing
    changes."""
    global _ACTIVE
    saved = _ACTIVE
    _ACTIVE = None if mesh is None else (mesh, parts)
    try:
        yield
    finally:
        _ACTIVE = saved


def active_mesh() -> tuple[DataParallelMesh, int] | None:
    """The (mesh, parts) set by ``active``, or None."""
    return _ACTIVE


def pad_to_multiple(batch: np.ndarray, multiple: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad the leading axis to a multiple of ``multiple`` by repeating the last row;
    returns (padded, validity mask). Keeps a ragged last batch divisible for
    sharding."""
    n = batch.shape[0]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return batch, np.ones(n, bool)
    pad = np.repeat(batch[-1:], target - n, axis=0)
    mask = np.zeros(target, bool)
    mask[:n] = True
    return np.concatenate([batch, pad], axis=0), mask


__all__: Sequence[str] = (
    "DataParallelMesh", "active", "active_mesh", "data_parallel_mesh", "pad_to_multiple",
)
