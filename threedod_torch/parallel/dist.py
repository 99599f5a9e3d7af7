"""Data parallelism over processes (counterpart of
``threedod/parallel/mesh.py``).

Under the JAX mesh, XLA computes one step over the global batch: the
BatchNorm statistics, the loss normalisers and the draws with a batch axis
are the global batch's. The port keeps that meaning over N processes (ranks),
each holding B/N rows of a global batch of B:

* a reduction over the batch axis sums its numerator and its count over the
  ranks (``all_sum``; the BatchNorm moments, ``batch_moments``, average the
  ranks' equal-sized moments); the backward of that sum is the sum of the
  upstream gradients over the ranks;
* each rank backpropagates its share of the loss, its rows' numerator over
  the global count, so that the shares add up to the global loss and the
  parameters' gradients summed over ranks (``allreduce_grads``) are the
  global batch's. They are summed, not averaged (detectron2's DDP averages
  gradients of per-rank losses, with per-rank normalisers and BatchNorm);
* a draw with a batch axis is made at the global batch from the generator
  every rank holds, and each rank keeps its rows (``local_rows``).

Without a process group every helper is the identity and launches nothing,
so a one-process run is what it was before this module. With a group, even
of one process, the collectives run; each adds one to ``COLLECTIVES``. A
group of one computes what one process without a group computes.

The group comes from a launcher's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``: ``python -m
torch.distributed.run``) or from ``spawn``, which starts the ranks itself
and meets them through a file. NCCL on CUDA devices, gloo on the CPU (and,
asked for by name, between ranks that share one card).
"""
from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

logger = logging.getLogger(__name__)

COLLECTIVES = 0  # collectives launched
BUCKET_BYTES = 32 * 2 ** 20  # the gradients are summed in flat buckets of at most this size
TIMEOUT_S = 600.0  # a collective that waits longer raises


def active() -> bool:
    """Whether a process group is up (the helpers then launch collectives)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_primary() -> bool:
    """Rank 0, which writes checkpoints, logs and results; true without a group."""
    return rank() == 0


def _launched() -> None:
    global COLLECTIVES
    COLLECTIVES += 1


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    _launched()
    dist.all_reduce(out)
    return out


class _AllSum(torch.autograd.Function):
    """Sum over ranks whose backward is the sum over ranks of the upstream
    gradients: rank r's input reaches every rank's loss share."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad)


def all_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (differentiable); ``x`` itself without a group."""
    if not active():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllSum.apply(x)
    return _all_reduce(x)


def global_batch(b: int) -> int:
    """The global batch of ``b`` rows a rank (every rank holds as many)."""
    return b * world_size()


def local_rows(x):
    """This rank's rows of ``x``, whose leading axis is the global batch (a
    tensor, an array, or a NamedTuple of them such as a Batch, None kept);
    ``x`` itself without a group."""
    if not active() or x is None:
        return x
    if hasattr(x, "_fields"):
        return type(x)(*(local_rows(f) for f in x))
    n, r = x.shape[0] // world_size(), rank()
    return x[r * n:(r + 1) * n]


def batch_moments(x: torch.Tensor, dims) -> tuple:
    """(mean, mean of squares) of ``x`` over ``dims`` of the global batch,
    ``x.mean(dims)`` and ``x.square().mean(dims)`` on one process. With a
    group, every rank holds as many elements (B/N rows of one canvas), so the
    global moments are the ranks' moments summed over the ranks in one
    collective and divided by the world size; a world of one computes the
    one-process moments bit for bit."""
    m, sq = x.mean(dim=dims), x.square().mean(dim=dims)
    if not active():
        return m, sq
    total = all_sum(torch.cat([m, sq])) / world_size()
    return total[:x.shape[1]], total[x.shape[1]:]


def allreduce_grads(grads: Sequence[torch.Tensor]) -> None:
    """Sum the gradients over the ranks in place, in flat buckets of one
    dtype and at most ``BUCKET_BYTES``; nothing without a group."""
    if not active():
        return
    buckets: List[List[torch.Tensor]] = []
    size = 0
    for g in grads:  # in order; a new bucket at a new dtype or a full one
        nbytes = g.numel() * g.element_size()
        if not buckets or buckets[-1][0].dtype != g.dtype or size + nbytes > BUCKET_BYTES:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += nbytes
    for bucket in buckets:
        flat = _flatten_dense_tensors(bucket)
        _launched()
        dist.all_reduce(flat)
        torch._foreach_copy_(bucket, list(_unflatten_dense_tensors(flat, bucket)))


def all_gather_objects(obj) -> list:
    """Every rank's ``obj`` (picklable), in rank order, on every rank."""
    if not active():
        return [obj]
    out = [None] * world_size()
    _launched()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    _launched()
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    if active():
        _launched()
        dist.barrier()


# ---------------------------------------------------------------------------
# the size of the world, and bringing the group up
# ---------------------------------------------------------------------------

def world_for_batch(batch_size: int, device: torch.device, wanted: Optional[int] = None) -> int:
    """The ranks to spawn for a global batch on ``device``'s type: ``wanted``
    (by default every visible card, 1 on the CPU) cut to the largest count
    that divides the batch (``make_mesh_for_batch``'s rule), with its
    warning."""
    cuda = torch.device(device).type == "cuda"
    available = torch.cuda.device_count() if cuda else 1
    wanted = available if wanted is None else wanted
    if cuda and wanted > available:
        raise ValueError(f"{wanted} ranks asked for: only {available} CUDA devices are visible")
    n = max(wanted, 1)
    while batch_size % n:
        n -= 1
    if n != wanted:
        logger.warning("global batch %d not divisible by %d devices; data parallelism uses %d",
                       batch_size, wanted, n)
    return n


def check_divides(batch_size: int) -> None:
    """Under a running group, refuse a global batch its world does not divide.
    The mesh drops devices that do not divide the batch; a process cannot be
    dropped from a group once it runs, so this raises instead."""
    w = world_size()
    if batch_size % w:
        raise ValueError(f"global batch {batch_size} is not divisible by the {w} ranks of the process group; "
                         f"launch a world that divides it")


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init(rank_: int, world: int, init_method: str, device: torch.device, backend: Optional[str] = None) -> None:
    """Join the group of ``world`` ranks at ``init_method`` as ``rank_``,
    NCCL on a CUDA device and gloo on the CPU unless ``backend`` says."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend or backend_for(device), init_method=init_method, rank=rank_, world_size=world,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))


def launched_externally() -> bool:
    """Whether a launcher (``torch.distributed.run``) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device_type: str) -> torch.device:
    """Join the launcher's group; -> this rank's device (``cuda:LOCAL_RANK``
    or the CPU)."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device("cuda", local) if device_type == "cuda" else torch.device("cpu")
    init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device)
    return device


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


@contextlib.contextmanager
def rank_scope():
    """How a rank leaves the group around its work: on success the ranks meet
    once more, then leave. Without that barrier a rank whose work is done
    could tear its side of the group down while a peer is still connecting to
    it (gloo's "connectFullMesh failed ... Connection closed by peer"). A rank
    that raises leaves at once; a peer's barrier then fails, and that peer,
    its own work done, only logs it, so that the rank that failed is the one
    whose error is reported."""
    try:
        yield
    except BaseException:
        shutdown()
        raise
    if active():
        try:
            dist.barrier()
        except RuntimeError as e:  # a peer left early; its own exit reports why
            logger.warning("a peer left the process group before the last barrier: %s", e)
    shutdown()


def _entry(rank_: int, fn: Callable, world: int, init_method: str, devices: Sequence[str],
           backend: Optional[str], args) -> None:
    init(rank_, world, init_method, torch.device(devices[rank_]), backend)
    with rank_scope():
        fn(*args)


def spawn(fn: Callable, devices: Sequence[str], args: tuple = (), backend: Optional[str] = None,
          timeout_s: Optional[float] = None) -> None:
    """Run ``fn(*args)`` in ``len(devices)`` fresh processes (the ``spawn``
    start method, ``torch.multiprocessing.start_processes``), rank r on
    ``devices[r]`` inside one process group that meets through a file in a
    temporary folder. ``fn`` must be importable by name. Raises when a rank
    fails, or when ``timeout_s`` passes first; the other ranks are then
    killed."""
    folder = tempfile.mkdtemp(prefix="threedod_dist_")
    init_method = "file://" + os.path.join(folder, "rendezvous")
    world = len(devices)
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    ctx = None
    try:
        ctx = torch_mp.start_processes(_entry, (fn, world, init_method, [str(d) for d in devices], backend, args),
                                       nprocs=world, join=False, start_method="spawn")
        while True:
            wait = None if deadline is None else deadline - time.monotonic()
            if wait is not None and wait <= 0:
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
            try:
                if ctx.join(None if wait is None else min(wait, 1.0)):  # every rank ended
                    break
            except (torch_mp.ProcessRaisedException, torch_mp.ProcessExitedException) as e:  # the rest were killed
                raise RuntimeError(f"rank {e.error_index} of {world} exited: {e}") from e
    finally:
        for p in [] if ctx is None else ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(folder, ignore_errors=True)


def _rank_main(fn: Callable, args, devices: Sequence[str], threads: int, result_path: str) -> None:
    """One rank of ``run_ranks``: ``fn(args, device)``; rank 0 leaves the
    result, a JSON object, in ``result_path``."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s", force=True)
    torch.set_num_threads(threads)
    out = fn(args, torch.device(devices[rank()]))
    if is_primary():
        with open(result_path, "w") as f:
            json.dump(out, f, default=float)


def run_ranks(fn: Callable, args, device: torch.device, world: int,
              timeout_s: Optional[float] = None) -> Optional[dict]:
    """A tool's ``fn(args, device)`` (importable by name, returning a JSON
    object) over its ranks: this process's rank of a launcher's group where
    ``RANK`` and ``WORLD_SIZE`` are set (``world`` is then the launcher's);
    else ``world`` spawned ranks, one card each (NCCL) or all on the CPU
    (gloo), each with this process's count of CPU threads, within
    ``timeout_s`` where given; else (``world`` 1) this process alone,
    without a group. Returns rank 0's result (None on the other ranks of a
    launch)."""
    device = torch.device(device)
    if launched_externally():
        device = init_from_env(device.type)
        primary = is_primary()
        with rank_scope():
            out = fn(args, device)
        return out if primary else None
    if world == 1:
        return fn(args, device)
    devices = [f"cuda:{r}" for r in range(world)] if device.type == "cuda" else ["cpu"] * world
    folder = tempfile.mkdtemp(prefix="threedod_ranks_")
    try:
        path = os.path.join(folder, "rank0.json")
        spawn(_rank_main, devices, (fn, args, devices, torch.get_num_threads(), path), timeout_s=timeout_s)
        with open(path) as f:
            return json.load(f)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
