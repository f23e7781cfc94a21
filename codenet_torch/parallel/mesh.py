"""Data parallelism over torch.distributed (the JAX package's
parallel/mesh.py).

The JAX package shards each batch over a 1-D 'data' mesh of every chip
and lets XLA insert the collectives: the gradient all-reduce, the
global-batch BN statistics, the global activation ranges of QAT and the
loss normalisers. Here one process drives one card (its *rank*), holds a
full replica of the model and loads only its rows of each global batch
(parallel/multihost.py); the collectives are explicit:

- every train-mode BatchNorm reduces over the global batch
  (models/layers.py::BatchNorm2d), and every QAT activation range is the
  global one (ops/quant.py::act_range_observe);
- every batch-wide count that divides a loss, and every branch taken on
  one, is the all-reduced count (models/losses.py), so each rank's loss
  is its numerator over the global denominator and the ranks' losses sum
  to the single-process loss;
- the gradients are summed across ranks by hand after the backward
  (`all_reduce_grads`: the deform kernel's per-rank dw is summed as the
  Pallas partition rule's psum sums it), then every rank takes the same
  Adam step; the logged stats are all-reduced sums.

So every rank holds bit-equal state after every step, and a run on W
ranks is the single-process run on the concatenated batch up to the
order of f32 sums.

Ranks start in one of three ways: `launch` spawns one process per device
(the training CLI's ``--gpus 0,1,...``); `join_from_env` joins a group
that torchrun (or any launcher setting RANK, WORLD_SIZE, LOCAL_RANK and
MASTER_ADDR / MASTER_PORT) formed; tests and the smoke test call
`launch` with explicit devices and backend (two gloo ranks sharing one
card, or gloo ranks on the CPU). Cards talk over NCCL; a missing NCCL
raises rather than falling back to gloo.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR")


def world_for_batch(batch_size, n):
    """The most ranks, at most `n`, that evenly divide `batch_size` (the
    JAX package's get_mesh_for_batch: each rank takes an equal share)."""
    while n > 1 and batch_size % n != 0:
        n -= 1
    return n


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group: its index, the group's size, its
    device and the backend of the default process group it joined."""
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def main(self):
        return self.rank == 0


def backend_for(device):
    """NCCL between cards, gloo between CPU processes. A card without NCCL
    raises: gloo between cards is only ever asked for explicitly."""
    if torch.device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "data-parallel training across cards needs NCCL, which "
                "this torch build lacks")
        return "nccl"
    return "gloo"


def launched_by_torchrun(environ=None):
    environ = os.environ if environ is None else environ
    return all(k in environ for k in TORCHRUN_ENV)


def _start(rank, world, device, backend, init_method):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    return DataParallel(rank, world, device, backend)


def join_from_env(batch_size, cpu=False, backend=None):
    """Join the group a launcher formed (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). The rank drives card LOCAL_RANK, or the
    CPU over gloo with cpu=True (``--gpus -1``). A world that does not
    divide the global batch raises."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if batch_size % world:
        raise ValueError(
            "the global batch {} does not divide over the {} ranks of "
            "this group; pick a batch that is a multiple of the world "
            "size".format(batch_size, world))
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]))
    return _start(rank, world, device, backend or backend_for(device),
                  "env://")


def leave(dp):
    if dp is not None and dist.is_initialized():
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker(rank, fn, devices, backend, port, args):
    dp = _start(rank, len(devices), devices[rank], backend,
                "tcp://127.0.0.1:{}".format(port))
    try:
        fn(dp, *args)
    finally:
        leave(dp)


def launch(fn, devices, backend=None, args=()):
    """Run fn(dp, *args) in one spawned process per entry of `devices`
    (rank k on devices[k]; entries may repeat: two gloo ranks can share a
    card) and wait for all of them. `fn` must be importable by name (a
    module-level function); a rank that raises makes this raise."""
    devices = [str(d) for d in devices]
    backend = backend or backend_for(devices[0])
    torch.multiprocessing.start_processes(
        _worker, args=(fn, devices, backend, _free_port(), tuple(args)),
        nprocs=len(devices), join=True, start_method="spawn")


# -- collectives (every helper is the identity when dp is None) ------------

def all_sum(t, dp):
    """t summed over the ranks (a new tensor)."""
    if dp is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def all_max(t, dp):
    """The elementwise max of t over the ranks (a new tensor)."""
    if dp is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t


def all_gather_rows(t, dp):
    """Every rank's t (one shape on every rank) stacked in rank order,
    (world,) + t.shape. It is an all-reduce of a zero-padded buffer: gloo
    reduces CUDA tensors but gathers none, and x + 0 is x."""
    if dp is None:
        return t[None]
    buf = t.new_zeros((dp.world,) + tuple(t.shape))
    buf[dp.rank] = t.detach()
    dist.all_reduce(buf)
    return buf


def barrier(dp):
    if dp is not None:
        dist.barrier()


def broadcast_module(module, dp):
    """Rank 0's parameters and buffers on every rank."""
    if dp is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def all_reduce_grads(params, dp):
    """Sum every parameter's gradient over the ranks, as one flat buffer
    (a parameter without a gradient has none on every rank: the ranks
    run one graph)."""
    if dp is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def _digest(t):
    """Two int64 sums over the bytes of t: equal tensors give equal
    digests; different ones almost surely do not."""
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).long()
    pos = torch.arange(b.numel(), device=b.device) % 65521 + 1
    return torch.stack([b.sum(), (b * pos).sum()])


def check_replicas_equal(module, dp):
    """Raise unless every rank holds bit-equal parameters and buffers
    (compared through digests of their bytes)."""
    if dp is None or dp.world == 1:
        return
    tensors = list(module.state_dict().values())
    d = torch.cat([_digest(t) for t in tensors])
    lo = all_max(-d, dp)
    hi = all_max(d, dp)
    if not torch.equal(-lo, hi):
        bad = sorted({i // 2 for i in range(len(d))
                      if int(-lo[i]) != int(hi[i])})
        names = list(module.state_dict())
        raise RuntimeError(
            "data-parallel replicas diverged in {}".format(
                [names[i] for i in bad[:5]]))
