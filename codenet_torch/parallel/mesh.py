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

With ``--spatial_shard k`` (the JAX package's get_mesh_2d) the ranks
form a data x spatial grid: rank d * k + s takes data row d (its rows of
each global batch) and spatial slot s (its band of rows of each image);
`grid` builds the process groups of each row and slot. The backbone runs
on the bands: each conv and pool takes the rows it needs from its
neighbours (`halo_rows`), every backbone BN and quantizer reduces over
the whole grid, and `gather_rows` puts the map together again ahead of
the deform stage, which each rank of a row then runs on the same map,
reducing over its data group alone (models/shufflenetv2.py). The loss is
counted once: each rank of a row scales it by 1/k, the gather's backward
sums the rows' gradients (a reduce-scatter), and the gradients are summed
over the world as with k = 1.

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


SPATIAL_MESSAGE = ("--spatial_shard {} does not divide the device count "
                   "{}; pick a divisor of the number of chips")


def grid_for_batch(batch_size, n, spatial):
    """The ranks of a data x spatial grid over at most `n` (the JAX
    get_mesh_2d): `spatial` must divide n (ValueError, the JAX message);
    the data axis, n // spatial, shrinks until it divides the batch.
    Returns (data rows, spatial)."""
    if n % spatial:
        raise ValueError(SPATIAL_MESSAGE.format(spatial, n))
    return world_for_batch(batch_size, n // spatial), spatial


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """One rank of a data-parallel group: its index, the group's size, its
    device and the backend of the default process group it joined; the
    collectives run over `group` (None: the default group).

    On a data x spatial grid (`spatial` > 1, made by `grid`) rank
    d * spatial + s holds data row d and spatial slot s;
    `spatial_group` holds the ranks of its row, `data_group` those of its
    slot. `over_spatial` and `over_data` are those groups as
    DataParallel of their own (over_data is None for one data row: a
    reduction over it is this rank's own)."""
    rank: int
    world: int
    device: torch.device
    backend: str
    spatial: int = 1
    group: object = None
    spatial_group: object = None
    data_group: object = None

    @property
    def main(self):
        return self.rank == 0

    @property
    def data_rank(self):
        return self.rank // self.spatial

    @property
    def data_world(self):
        return self.world // self.spatial

    @property
    def spatial_rank(self):
        return self.rank % self.spatial

    @property
    def over_data(self):
        if self.spatial == 1:
            return self
        if self.data_world == 1:
            return None
        return DataParallel(self.data_rank, self.data_world, self.device,
                            self.backend, group=self.data_group)

    @property
    def over_spatial(self):
        return DataParallel(self.spatial_rank, self.spatial, self.device,
                            self.backend, group=self.spatial_group)


# grids made in this process, by spatial size (process groups are made
# collectively, so each is made once)
_GRIDS = {}


def grid(dp, spatial):
    """`dp`'s ranks as a data x `spatial` grid (dp itself for 1). Every
    rank of dp must call it, with the same `spatial`. A world that
    `spatial` does not divide raises ValueError, one process (dp None)
    included, as the JAX get_mesh_2d does on too few devices."""
    world = 1 if dp is None else dp.world
    if world % spatial:
        raise ValueError(SPATIAL_MESSAGE.format(spatial, world))
    if spatial == 1 or dp.spatial == spatial:
        return dp
    if spatial not in _GRIDS:
        rows = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                for d in range(world // spatial)]
        slots = [dist.new_group(list(range(s, world, spatial)))
                 for s in range(spatial)]
        _GRIDS[spatial] = rows, slots
    rows, slots = _GRIDS[spatial]
    return dataclasses.replace(dp, spatial=spatial,
                               spatial_group=rows[dp.rank // spatial],
                               data_group=slots[dp.rank % spatial])


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


def join_from_env(batch_size, cpu=False, backend=None, spatial=1):
    """Join the group a launcher formed (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT). The rank drives card LOCAL_RANK, or the
    CPU over gloo with cpu=True (``--gpus -1``). With `spatial` > 1 the
    group is a data x spatial grid (`grid`). A world that `spatial` does
    not divide, or whose data axis does not divide the global batch,
    raises."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if world % spatial:
        raise ValueError(SPATIAL_MESSAGE.format(spatial, world))
    rows = world // spatial
    if batch_size % rows:
        raise ValueError(
            "the global batch {} does not divide over the {} ranks of "
            "this group; pick a batch that is a multiple of the world "
            "size".format(batch_size, world) if spatial == 1 else
            "the global batch {} does not divide over the {} data rows "
            "of this group ({} ranks, --spatial_shard {})".format(
                batch_size, rows, world, spatial))
    device = torch.device("cpu") if cpu else torch.device(
        "cuda", int(os.environ["LOCAL_RANK"]))
    dp = _start(rank, world, device, backend or backend_for(device),
                "env://")
    return grid(dp, spatial)


def leave(dp):
    _GRIDS.clear()
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
    dist.all_reduce(t, group=dp.group)
    return t


def all_max(t, dp):
    """The elementwise max of t over the ranks (a new tensor)."""
    if dp is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.group)
    return t


def all_gather_rows(t, dp):
    """Every rank's t (one shape on every rank) stacked in rank order,
    (world,) + t.shape. It is an all-reduce of a zero-padded buffer: gloo
    reduces CUDA tensors but gathers none, and x + 0 is x."""
    if dp is None:
        return t[None]
    buf = t.new_zeros((dp.world,) + tuple(t.shape))
    buf[dp.rank] = t.detach()
    dist.all_reduce(buf, group=dp.group)
    return buf


def barrier(dp):
    if dp is not None:
        dist.barrier(group=dp.group)


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


# -- image rows split over the spatial ranks (--spatial_shard) -------------
# A map split over the `sp` ranks of a spatial group (a DataParallel
# over_spatial) holds rows [s * h, (s + 1) * h) of its H = sp * h rows on
# rank s, in (N, C, h, W) channels_last tensors. Both exchanges are an
# all-reduce of a zero-filled buffer, as `all_gather_rows` is: gloo reduces
# CUDA tensors but gathers none, and x + 0 is x.

def band(height, sp):
    """Rank sp.rank's rows [lo, hi) of `height` rows split over sp.world
    ranks (height must divide)."""
    h = height // sp.world
    return sp.rank * h, (sp.rank + 1) * h


def halo_plan(h, ranks, kernel, stride, padding, dilation=1):
    """The input rows [a, b) each of `ranks` ranks reads to compute its
    band of the output of a (kernel, stride, padding, dilation) window
    over H = ranks * h rows: rank t's output rows are [t * ho, (t + 1) *
    ho), ho = Hout / ranks, and a < 0 or b > H reach into the padding.
    An output whose rows do not split over the ranks raises."""
    height = h * ranks
    out = (height + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    if out % ranks:
        raise ValueError("{} output rows do not split over {} ranks"
                         .format(out, ranks))
    ho = out // ranks
    return [(t * ho * stride - padding,
             ((t + 1) * ho - 1) * stride - padding
             + dilation * (kernel - 1) + 1) for t in range(ranks)]


def _span(lo, hi):
    return lo, max(lo, hi)


def _halo_slots(h, plan):
    """Each rank's halo as rows of the exchange buffer: per rank t, the
    rows [lo, hi) of the image it reads from the ranks above it, then
    from those below it, at buffer offsets off. Returns [(t, lo, hi,
    off)] and the buffer's length."""
    height = h * len(plan)
    slots, off = [], 0
    for t, (a, b) in enumerate(plan):
        for lo, hi in (_span(max(a, 0), min(b, t * h)),
                       _span(max(a, (t + 1) * h), min(b, height))):
            if hi > lo:
                slots.append((t, lo, hi, off))
                off += hi - lo
    return slots, off


def _owned(lo, hi, s, h):
    """The part of rows [lo, hi) that rank s (rows [s * h, (s + 1) * h))
    holds, or None."""
    lo, hi = max(lo, s * h), min(hi, (s + 1) * h)
    return (lo, hi) if hi > lo else None


class _HaloRows(torch.autograd.Function):
    """`halo_rows`: forward, each rank's band widened to the rows its
    window reads (neighbours' rows through the exchange, `fill` beyond
    the image's edges); backward, the gradient of the rows a rank took
    from its neighbours goes back to them and is added there."""

    @staticmethod
    def forward(ctx, x, sp, plan, fill):
        n, c, h, w = x.shape
        s = sp.rank
        a, b = plan[s]
        slots, length = _halo_slots(h, plan)
        xh = x.permute(0, 2, 3, 1)                    # (N, h, W, C)
        buf = x.new_zeros((n, length, w, c))
        for t, lo, hi, off in slots:
            part = _owned(lo, hi, s, h) if t != s else None
            if part:
                buf[:, off + part[0] - lo:off + part[1] - lo] = \
                    xh[:, part[0] - s * h:part[1] - s * h]
        dist.all_reduce(buf, group=sp.group)
        height = h * sp.world
        pieces = []
        if a < 0:
            pieces.append(x.new_full((n, min(b, 0) - a, w, c), fill))
        for t, lo, hi, off in slots:
            if t == s and hi <= s * h:
                pieces.append(buf[:, off:off + hi - lo])
        own = _owned(a, b, s, h)
        if own:
            pieces.append(xh[:, own[0] - s * h:own[1] - s * h])
        for t, lo, hi, off in slots:
            if t == s and lo >= (s + 1) * h:
                pieces.append(buf[:, off:off + hi - lo])
        if b > height:
            pieces.append(x.new_full((n, b - max(a, height), w, c), fill))
        ctx.sp, ctx.plan, ctx.shape = sp, plan, x.shape
        return torch.cat(pieces, 1).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        sp, plan = ctx.sp, ctx.plan
        n, c, h, w = ctx.shape
        s = sp.rank
        a, _ = plan[s]
        slots, length = _halo_slots(h, plan)
        g = grad.permute(0, 2, 3, 1)                 # rows [a, b)
        buf = grad.new_zeros((n, length, w, c))
        for t, lo, hi, off in slots:
            if t == s:
                buf[:, off:off + hi - lo] = g[:, lo - a:hi - a]
        dist.all_reduce(buf, group=sp.group)
        dx = grad.new_zeros((n, h, w, c))
        own = _owned(*plan[s], s, h)
        if own:
            dx[:, own[0] - s * h:own[1] - s * h] = \
                g[:, own[0] - a:own[1] - a]
        for t, lo, hi, off in slots:
            part = _owned(lo, hi, s, h) if t != s else None
            if part:
                dx[:, part[0] - s * h:part[1] - s * h] += \
                    buf[:, off + part[0] - lo:off + part[1] - lo]
        return dx.permute(0, 3, 1, 2), None, None, None


def halo_rows(x, sp, kernel, stride, padding, dilation=1, fill=0.0):
    """This rank's band x (N, C, h, W) of a map split over the spatial
    group `sp`, widened to the input rows [a, b) that its band of a
    (kernel, stride, padding, dilation) window's output reads
    (`halo_plan`): rows of the neighbours exchanged, `fill` above and
    below the image (0 for a conv's zero padding, -inf for a max pool's).
    A window over the result with vertical padding 0 gives this rank's
    output rows. Differentiable: a halo's gradient returns to its
    owner."""
    plan = halo_plan(x.shape[2], sp.world, kernel, stride, padding,
                     dilation)
    return _HaloRows.apply(x, sp, plan, fill)


class _GatherRows(torch.autograd.Function):
    """`gather_rows`: forward, the all-gather of the bands; backward, the
    reduce-scatter of the whole map's gradient (summed over the group,
    this rank's band kept)."""

    @staticmethod
    def forward(ctx, x, sp):
        n, c, h, w = x.shape
        buf = x.new_zeros((n, h * sp.world, w, c))
        buf[:, sp.rank * h:(sp.rank + 1) * h] = x.permute(0, 2, 3, 1)
        dist.all_reduce(buf, group=sp.group)
        ctx.sp, ctx.h = sp, h
        return buf.permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        sp, h = ctx.sp, ctx.h
        g = grad.permute(0, 2, 3, 1).contiguous()
        dist.all_reduce(g, group=sp.group)
        band_ = g[:, sp.rank * h:(sp.rank + 1) * h].contiguous()
        return band_.permute(0, 3, 1, 2), None


def gather_rows(x, sp):
    """The whole map (N, C, H, W) from each rank's band x (N, C, h, W)
    over the spatial group `sp`, on every rank of it (channels_last)."""
    return _GatherRows.apply(x, sp)


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
