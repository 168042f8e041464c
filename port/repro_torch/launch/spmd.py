"""Run one function in N processes joined in one process group: the port's
counterpart of the reference's single program over a mesh of devices.

  results = spmd.run(fn, devices, backend, args)

Process ``r`` (``r < len(devices)``) joins the default process group of
``len(devices)`` ranks with ``backend``, makes ``devices[r]`` its device
(``torch.cuda.set_device`` on a card), calls ``fn(r, devices[r], *args)``
and hands its result back to the parent, which returns them in rank
order.  ``fn`` must be importable by name (a module-level function), its
arguments and result picklable.

- The processes are started with the ``spawn`` method, never ``fork``: a
  parent that has already imported JAX, or touched a card, cannot fork
  safely.
- They meet through a ``torch.distributed.FileStore`` in a temporary
  directory: no TCP port, so two launches on one host never collide.
- An exception in any process fails the parent (``torch.multiprocessing``
  raises it with the child's traceback and ends the other processes):
  nothing is caught and carried past.

:func:`card_layout` is the layout the port uses on a machine with cards:
one card a rank over NCCL when there are enough, else every rank on
``cuda:0`` over gloo (NCCL refuses two ranks on one card).  The caller
chooses; nothing here picks the CPU.

Under gloo, every process stages the functional collectives (DTensor's
and the port's own) through host memory itself
(:func:`stage_through_host`): each tensor is copied to the host, reduced
or gathered there by gloo's all-reduce and ``all_gather_into_tensor``
into one buffer, and copied back.  Gloo's own path for card tensors is
not used: in torch 2.11 the first of DTensor's functional collectives on
it (an all-gather) ended the process with a segmentation fault on an
H100.  Nor, on the CPU, are gloo's all-to-all and its list-of-tensors
all-gather: a rank of a CPU test once died with ``malloc(): unaligned
tcache chunk detected`` on that path.  (DTensor's shard all-to-all on a
CPU mesh is its own fallback, an all-gather and a chunk, which is staged
so too.)
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch

__all__ = ["run", "card_layout", "stage_through_host"]


def card_layout(n: int) -> tuple:
    """(backend, devices) for ``n`` ranks on this machine's cards."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have == 0:
        raise RuntimeError("no CUDA device (pass devices and backend to "
                           "run on the CPU)")
    if have >= n:
        return "nccl", [torch.device("cuda", r) for r in range(n)]
    return "gloo", [torch.device("cuda", 0)] * n


_LIBS: list = []     # the kernels stage_through_host registered


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name) if isinstance(name, str) else name


def _host(x: torch.Tensor) -> torch.Tensor:
    """A host copy of ``x`` (never ``x`` itself: gloo reduces in place,
    and a functional collective leaves its input as it was); bf16 and f16
    as f32, so that gloo reduces in f32 (a sum of two ranks' values then
    rounds once, as on the card)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.detach().float().cpu()
    return x.detach().to("cpu", copy=True).contiguous()


def _op(reduce_op: str):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[reduce_op.lower()]


def _all_gather(input, group_size, group_name):
    import torch.distributed as dist
    x = _host(input)
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=_group(group_name))
    return out.to(input.device, input.dtype)


def _all_reduce(input, reduce_op, group_name):
    import torch.distributed as dist
    x = _host(input)
    dist.all_reduce(x, op=_op(reduce_op), group=_group(group_name))
    return x.to(input.device, input.dtype)


def _reduce_scatter(input, reduce_op, group_size, group_name):
    """An all-reduce, then this rank's chunk of dimension 0 (gloo has no
    reduce-scatter on every build)."""
    import torch.distributed as dist
    x = _host(input)
    pg = _group(group_name)
    dist.all_reduce(x, op=_op(reduce_op), group=pg)
    r = dist.get_group_rank(pg, dist.get_rank())
    return x.chunk(group_size)[r].to(input.device, input.dtype)


def _gathered(x: torch.Tensor, pg, n: int) -> torch.Tensor:
    """Every rank's host tensor ``x`` stacked in rank order, (n, *x.shape),
    gathered into one buffer (``all_gather_into_tensor``, as
    :func:`_all_gather`; gloo's list-of-tensors all-gather is not used)."""
    import torch.distributed as dist
    flat = x.reshape((1,) + tuple(x.shape)).contiguous()   # gloo: dim 0
    out = flat.new_empty((n,) + tuple(x.shape))
    dist.all_gather_into_tensor(out, flat, group=pg)
    return out


def _all_to_all(input, output_split_sizes, input_split_sizes, group_name):
    """Equal splits of dimension 0 only, through an all-gather of every
    rank's input (gloo has no all-to-all on every build)."""
    import torch.distributed as dist
    pg = _group(group_name)
    n = pg.size()
    if len(set(input_split_sizes) | set(output_split_sizes)) > 1:
        raise NotImplementedError("uneven all-to-all splits")
    parts = _gathered(_host(input), pg, n)
    r = dist.get_group_rank(pg, dist.get_rank())
    out = torch.cat([p.chunk(n)[r] for p in parts])
    return out.to(input.device, input.dtype)


def _shard_dim_alltoall(input, gather_dim, shard_dim, group_name):
    import torch.distributed as dist
    pg = _group(group_name)
    n = pg.size()
    whole = torch.cat(list(_gathered(_host(input), pg, n)), dim=gather_dim)
    r = dist.get_group_rank(pg, dist.get_rank())
    piece = whole.chunk(n, dim=shard_dim)[r].contiguous()
    return piece.to(input.device, input.dtype)


def stage_through_host(key: str = "CUDA") -> None:
    """Make torch's functional collectives on ``key`` tensors (``"CUDA"``;
    the tests pass ``"CPU"``) run on host copies through the default
    group's gloo collectives: what DTensor's redistributions issue
    (all-gather, all-reduce, reduce-scatter, all-to-all) and its shard
    all-to-all.  Each returns a finished tensor, so waiting on it is a
    no-op.  :func:`run` installs it in every gloo process, for its
    device's key."""
    if key in [k for k, _ in _LIBS]:
        return
    c10d = torch.library.Library("_c10d_functional", "IMPL")
    c10d.impl("all_gather_into_tensor", _all_gather, key)
    c10d.impl("all_reduce", _all_reduce, key)
    c10d.impl("reduce_scatter_tensor", _reduce_scatter, key)
    c10d.impl("all_to_all_single", _all_to_all, key)
    dt = torch.library.Library("_dtensor", "IMPL")
    dt.impl("shard_dim_alltoall", _shard_dim_alltoall, key)
    _LIBS.append((key, (c10d, dt)))


def _child(rank: int, fn, devices: list, backend: str, tmp: str,
           args: tuple) -> None:
    import torch.distributed as dist

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend == "gloo" and dev.type in ("cpu", "cuda"):
        stage_through_host(dev.type.upper())
    store = dist.FileStore(os.path.join(tmp, "store"), len(devices))
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=len(devices), **kw)
    try:
        out = fn(rank, dev, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run(fn, devices, backend: str, args: tuple = ()) -> list:
    """``fn(rank, device, *args)`` in ``len(devices)`` spawned processes;
    their results in rank order (see the module docstring)."""
    devices = [str(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("no devices")
    with tempfile.TemporaryDirectory(prefix="spmd-") as tmp:
        torch.multiprocessing.start_processes(
            _child, args=(fn, devices, backend, tmp, tuple(args)),
            nprocs=len(devices), join=True, start_method="spawn")
        out = []
        for r in range(len(devices)):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
