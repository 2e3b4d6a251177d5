"""Device mesh, processes and the fan-in merge of the sharded serving layer
(counterpart of cloudvectordb_tpu/parallel/mesh.py).

The reference is single-controller SPMD: one process runs ``shard_map`` over
the devices of a JAX ``Mesh``, and ``init_multihost`` adds processes, each
owning the mesh devices it addresses. Here a ``Mesh`` is a small object: a
grid of shard slots, each with its ``torch.device`` and its owning process
(rank), under the axis names ``('shard',)`` or ``('replica', 'shard')``,
and the ``torch.distributed`` process group that spans the processes (None
with one process). Slots go to processes in contiguous blocks, as JAX
orders its global devices process by process, and a process's slots take
its devices round-robin: ``make_mesh(4)`` on one card is four shards on
``cuda:0``, and ``make_mesh(8, devices=["cpu"])`` the CPU tests' stand-in
for the reference's eight simulated devices.

Each sharded index keeps one single-card index per shard it holds, on its
slot's device, runs that index's own plan and kernel there (the fan-out),
and merges the per-shard partial top-k in global shard order with one
stable top-k (``merge_partials``, the reference's ``all_gather`` +
``lax.top_k``): ties go to the lower shard, then the lower slot. Across
processes the partials cross by ``torch.distributed``; gloo moves CPU
tensors only, so processes that share a card (NCCL refuses two ranks on
one GPU) stage their partials through host memory. Every process must make
the same collective calls with the same shapes (``stage_queries`` and
``assert_equal_across_processes`` check the contract before a search), or
the collective hangs.
"""

from __future__ import annotations

import atexit
import copy
import datetime
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

from cloudvectordb_tpu_torch.ops.topk import NEG_INF, topk_stable_select
from cloudvectordb_tpu_torch.utils.device import DEFAULT, as_device


class Mesh:
    """Shard slots over devices and processes. ``devices`` and ``owners``
    are equal-shaped grids, (n_shard,) or (n_replica, n_shard): the
    ``torch.device`` of each slot (None for a slot another process owns)
    and its owning rank."""

    def __init__(self, devices: np.ndarray, axis_names: tuple, owners: np.ndarray,
                 group=None):
        if devices.shape != owners.shape or devices.ndim != len(axis_names):
            raise ValueError(f"devices {devices.shape}, owners {owners.shape}, axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.owners = owners
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.nproc = dist.get_world_size(group) if group is not None else 1

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def n_shard(self) -> int:
        return self.shape["shard"]

    @property
    def n_replica(self) -> int:
        return self.shape.get("replica", 1)

    def _grid(self, a: np.ndarray) -> np.ndarray:
        return a if a.ndim == 2 else a[None]

    def local_slots(self) -> list[tuple[int, int, torch.device]]:
        """(replica, shard, device) of every slot this process owns, in
        global order."""
        dev, own = self._grid(self.devices), self._grid(self.owners)
        return [(r, s, dev[r, s]) for r in range(dev.shape[0]) for s in range(dev.shape[1])
                if own[r, s] == self.rank]

    def local_replicas(self) -> list[int]:
        return sorted({r for r, _, _ in self.local_slots()})

    def holds(self, si: int) -> bool:
        """Whether this process owns a slot of shard ``si``."""
        return bool((self._grid(self.owners)[:, si] == self.rank).any())

    def slot_device(self, r: int, si: int) -> torch.device | None:
        return self._grid(self.devices)[r, si]

    def shard_device(self, si: int) -> torch.device:
        """The device of this process's first slot of shard ``si``."""
        col = self._grid(self.devices)[:, si]
        own = self._grid(self.owners)[:, si]
        for d, o in zip(col, own):
            if o == self.rank:
                return d
        raise ValueError(f"shard {si} is held by another process")

    def local_devices(self) -> list[torch.device]:
        out = []
        for _, _, d in self.local_slots():
            if d not in out:
                out.append(d)
        return out

    @property
    def gathers_across_processes(self) -> bool:
        """Whether a search's merge crosses processes: a 1-D mesh spread
        over several processes. On a mesh of one replica row per process
        each process merges its own row."""
        return self.nproc > 1 and self.n_replica == 1


def _world():
    return (dist.group.WORLD, dist.get_world_size(), dist.get_rank()) if (
        dist.is_available() and dist.is_initialized()) else (None, 1, 0)


def local_placement(num_processes: int, process_id: int) -> tuple[int, int]:
    """(local rank, local world size) of this process: the launcher's
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``, as ``torchrun`` sets them, or,
    without them, a job on one host (``process_id``, ``num_processes``)."""
    rank, size = os.environ.get("LOCAL_RANK"), os.environ.get("LOCAL_WORLD_SIZE")
    if rank is None and size is None:
        return process_id, num_processes
    if rank is None or size is None:
        raise ValueError(f"LOCAL_RANK={rank} and LOCAL_WORLD_SIZE={size}: the launcher "
                         "sets both or neither")
    rank, size = int(rank), int(size)
    if not 0 <= rank < size or size > num_processes:
        raise ValueError(f"local rank {rank} of {size} on a job of {num_processes} processes")
    return rank, size


def _card_of(local_rank: int, n_cards: int, backend: str) -> int:
    """The card a process of a group takes: its local rank. Processes that
    share a card (more of them on the host than cards) do so only under
    gloo, where the local rank wraps; with NCCL it raises."""
    if local_rank >= n_cards and backend == "nccl":
        raise ValueError(f"local rank {local_rank} with NCCL on a host of {n_cards} cards: "
                         "NCCL takes one card a process")
    return local_rank % n_cards


def _local_devices(devices, rank: int, world: int) -> list[torch.device]:
    """This process's devices: ``devices``, else every visible card for a
    process alone on its host (the reference's process owns all of its
    host's devices), else the card at its local rank."""
    if devices is not None:
        return [as_device(d) for d in devices]
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        local_rank, local_size = local_placement(world, rank) if world > 1 else (0, 1)
        if local_size > 1:
            return [torch.device("cuda", _card_of(local_rank, n, dist.get_backend()))]
        return [torch.device("cuda", i) for i in range(n)]
    return [as_device(DEFAULT)]  # raises torch's own error: no silent CPU mesh


def _place(shape: tuple, axis_names: tuple, devices) -> Mesh:
    group, world, rank = _world()
    n = int(np.prod(shape))
    if n < world:
        raise ValueError(f"{n} mesh slots for {world} processes: every process needs one")
    owners = (np.arange(n) * world // n).reshape(shape)
    local = _local_devices(devices, rank, world)
    devs = np.empty(n, dtype=object)
    mine = np.flatnonzero(owners.reshape(-1) == rank)
    for j, f in enumerate(mine):
        devs[f] = local[j % len(local)]
    return Mesh(devs.reshape(shape), axis_names, owners, group)


def make_mesh(n: int | None = None, axis_name: str = "shard", devices=None) -> Mesh:
    """1-D mesh of ``n`` shard slots over the processes (contiguous blocks)
    and, within a process, over ``devices`` (default: every visible card,
    or the card at the local rank of a process that shares its host with
    others) round-robin. ``n`` defaults to one slot per device of every
    process."""
    _, world, rank = _world()
    if n is None:
        n = len(_local_devices(devices, rank, world)) * world
    return _place((int(n),), (axis_name,), devices)


def make_2d_mesh(n_replica: int, n_shard: int, devices=None) -> Mesh:
    """('replica', 'shard') mesh: whole-index replicas split the query
    traffic, each query fans out over its replica's shards."""
    return _place((int(n_replica), int(n_shard)), ("replica", "shard"), devices)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str | None = None, timeout_s: float = 600.0) -> int:
    """Join ``num_processes`` processes into one ``torch.distributed`` group
    (``coordinator`` as ``host:port``, rank ``process_id``): gloo where the
    processes of a host share a card or have none, NCCL where each has a
    card of its own (``backend`` overrides), and then the card at its local
    rank (``local_placement``: the launcher's ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``, or one host). NCCL across cards is not measured
    (one card). Every failure raises; nothing degrades to one process.
    Returns the world size. Already initialized: checks that the group is
    this one. A group opened here is torn down at interpreter
    exit (``shutdown_multihost``), as ``jax.distributed.initialize``
    registers its own shutdown: a group left alive into interpreter
    teardown can abort the process (SIGABRT from its threads) after its
    work is done."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError(
                f"torch.distributed already up as rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, asked for {process_id} of {num_processes}")
        return num_processes
    local_rank, local_size = local_placement(num_processes, process_id)
    if backend is None:
        distinct_cards = torch.cuda.is_available() and torch.cuda.device_count() >= local_size
        backend = "nccl" if distinct_cards else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(_card_of(local_rank, torch.cuda.device_count(), backend))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if not _OWNED["registered"]:
        atexit.register(shutdown_multihost)
        _OWNED["registered"] = True
    _OWNED["group"] = True
    return dist.get_world_size()


#: whether init_multihost opened the live group (and registered its teardown)
_OWNED = {"group": False, "registered": False}


def shutdown_multihost() -> None:
    """End the group ``init_multihost`` opened: a barrier (no process tears
    the group down while another still uses it; rank 0 hosts its store),
    then ``destroy_process_group``. Runs once: a second call, or a group
    this module did not open, does nothing. Registered at exit."""
    if not _OWNED["group"]:
        return
    _OWNED["group"] = False
    if not dist.is_initialized():
        return
    try:
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _comm_device(group) -> torch.device:
    """Where a collective's tensors must lie: the process's card for NCCL,
    host memory for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every process's ``obj`` in rank order (one process: ``[obj]``)."""
    if mesh.group is None:
        return [obj]
    out = [None] * mesh.nproc
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def assert_equal_across_processes(values, context: str, mesh: Mesh) -> None:
    """Raise on every process (no deadlock) when an int tuple differs across
    processes: a collective that one rank enters with other shapes or
    knobs hangs instead of raising. One small gather; nothing with one
    process."""
    if mesh.group is None:
        return
    mine = tuple(int(v) for v in values)
    everyone = all_gather_object(mine, mesh)
    if any(v != mine for v in everyone):
        raise ValueError(f"multi-process contract violated ({context}): every process must "
                         f"pass identical values, got {everyone}")


def stage_queries(qp: np.ndarray, mesh: Mesh, *, statics=()):
    """Check the query batch of a collective search and return it (numpy).
    Every process passes the same batch shape and the same static knobs. On
    a mesh of one replica row per process ``qp`` is this process's own
    traffic; on any other mesh the batch is broadcast, so every process
    must pass the identical array, checked by a CRC."""
    qp = np.ascontiguousarray(qp)
    if mesh.group is None:
        return qp
    if mesh.n_replica not in (1, mesh.nproc):
        raise ValueError(f"multi-process serving needs one replica per process or a 1-D "
                         f"mesh: n_replica={mesh.n_replica}, processes={mesh.nproc}")
    crc_check = mesh.n_replica == 1
    crc = zlib.crc32(qp.tobytes()) if crc_check else 0
    assert_equal_across_processes(
        (*qp.shape, crc, *statics),
        "query batch shape" + ("+content" if crc_check else "") + "+static knobs", mesh)
    return qp


def fetch_local(arr) -> np.ndarray:
    """This process's result of a search as numpy."""
    return arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def stage_replicated(x, mesh: Mesh) -> dict:
    """``x`` (a host array or a tensor) on each of this process's mesh
    devices, one copy a device: {device: tensor}."""
    x = torch.as_tensor(x)
    return {d: x.to(d) for d in mesh.local_devices()}


def stage_row_sharded(piece_fn, n_shards: int, mesh: Mesh) -> dict:
    """Per-shard host pieces placed on their slots' devices without a dense
    host concatenation: {(replica, shard): tensor} for the slots this
    process owns. ``piece_fn(si)`` returns shard si's block (numpy or a
    tensor) and runs once per held shard, never for a shard another
    process holds."""
    if mesh.n_shard != n_shards:
        raise ValueError(f"mesh has {mesh.n_shard} shard slots, {n_shards} pieces")
    out, pieces = {}, {}
    for r, si, dev in mesh.local_slots():
        if si not in pieces:
            pieces[si] = torch.as_tensor(piece_fn(si))
        out[(r, si)] = pieces[si].to(dev)
    return out


def replica_slices(mesh: Mesh, nq: int) -> list[tuple[int, slice]]:
    """(replica, query slice) this process serves of a padded batch of
    ``nq``: with one process every replica's equal slice; with several the
    whole batch, which is this process's traffic on a replica-per-process
    mesh and the broadcast batch on a 1-D one."""
    if mesh.nproc > 1:
        return [(mesh.local_replicas()[0], slice(0, nq))]
    per = nq // mesh.n_replica
    return [(r, slice(r * per, (r + 1) * per)) for r in range(mesh.n_replica)]


def _pad_width(v: torch.Tensor, i: torch.Tensor, width: int):
    pad = width - v.shape[-1]
    if pad <= 0:
        return v, i
    return (torch.cat([v, v.new_full((*v.shape[:-1], pad), NEG_INF)], dim=-1),
            torch.cat([i, i.new_full((*i.shape[:-1], pad), -1)], dim=-1))


def merge_partials(parts: list, k: int, mesh: Mesh):
    """The fan-in: ``parts`` are this process's per-shard partial top-k
    ``(scores (B, kk) f32, global ids (B, kk))`` in global shard order. The
    (S, B, kk) stack (across processes on a 1-D multi-process mesh: gathered
    in rank order, which is global shard order) is transposed to (B, S·kk)
    and reduced by one stable top-k of min(k, S·kk): ties go to the lower
    shard, then the lower slot, as ``lax.top_k`` breaks them. Returns
    (scores, ids int64) on the first part's device (host memory when the
    merge crossed processes). A narrower part pads with (-inf, -1)."""
    width = max(v.shape[1] for v, _ in parts)
    dev = parts[0][0].device
    vs, ids = zip(*(_pad_width(v.to(dev), i.to(dev).long(), width) for v, i in parts))
    v, g = torch.stack(vs), torch.stack(ids)  # (S_local, B, kk)
    if mesh.gathers_across_processes:
        v, g = _gather_partials(v, g, mesh)
    s, b, kk = v.shape
    cand_v = v.transpose(0, 1).reshape(b, s * kk)
    cand_i = g.transpose(0, 1).reshape(b, s * kk)
    best, pos = topk_stable_select(cand_v, min(k, s * kk))
    return best, torch.gather(cand_i, 1, pos)


def _gather_partials(v: torch.Tensor, g: torch.Tensor, mesh: Mesh):
    """(S_local, B, kk) partials of every process, concatenated in rank
    order: ``all_gather`` when every process's stack has one shape, else
    ``all_gather_object`` of host copies (ragged shard counts or widths)."""
    shapes = all_gather_object(tuple(v.shape), mesh)
    if any(s != shapes[0] for s in shapes):
        objs = all_gather_object((v.cpu(), g.cpu()), mesh)
        width = max(o[0].shape[2] for o in objs)
        pv, pg = zip(*(_pad_width(a, b, width) for a, b in objs))
        return torch.cat(pv), torch.cat(pg)
    cdev = _comm_device(mesh.group)
    v, g = v.to(cdev).contiguous(), g.to(cdev).contiguous()
    out_v = [torch.empty_like(v) for _ in range(mesh.nproc)]
    out_g = [torch.empty_like(g) for _ in range(mesh.nproc)]
    dist.all_gather(out_v, v, group=mesh.group)
    dist.all_gather(out_g, g, group=mesh.group)
    return torch.cat(out_v), torch.cat(out_g)


def gather_shard_meta(local: dict, mesh: Mesh) -> list[dict]:
    """Every shard's small metadata (counts, scales, id bounds) on every
    process: each process contributes its held shards' ``local`` entries
    ({shard: dict}); a collective with several processes."""
    merged: dict = {}
    for part in all_gather_object(local, mesh):
        for si, m in part.items():
            merged.setdefault(si, m)
    missing = [si for si in range(mesh.n_shard) if si not in merged]
    if missing:
        raise ValueError(f"no process holds shards {missing}")
    return [merged[si] for si in range(mesh.n_shard)]


# -- data parallelism (training and encoding) ---------------------------------
def _axis_slots(mesh: Mesh, axis_name: str) -> list[tuple[int, torch.device]]:
    """(global slot index, device) of this process's slots on the 1-D mesh
    ``axis_name``."""
    if mesh.axis_names != (axis_name,):
        raise ValueError(f"a 1-D {axis_name!r} mesh is needed, got axes {mesh.axis_names}")
    return [(s, d) for _, s, d in mesh.local_slots()]


def data_sharding(mesh: Mesh, axis_name: str = "data"):
    """The batch axis split over this process's slots (the reference's
    ``NamedSharding(mesh, P(axis_name))``): a function ``x -> [piece, ...]``
    giving each of this process's slots, in slot order, its contiguous
    equal slice of ``x`` on its device. ``x`` is this process's own data
    (the reference's ``make_array_from_process_local_data``); its length
    must divide by the process's slot count."""
    devs = [d for _, d in _axis_slots(mesh, axis_name)]

    def place(x) -> list[torch.Tensor]:
        x = torch.as_tensor(x)
        if x.shape[0] % len(devs):
            raise ValueError(f"{x.shape[0]} rows do not split over {len(devs)} slots")
        per = x.shape[0] // len(devs)
        return [x[j * per:(j + 1) * per].to(d) for j, d in enumerate(devs)]

    return place


def replicated(mesh: Mesh):
    """A replica per slot of this process (the reference's
    ``NamedSharding(mesh, P())`` for the parameters): a function ``module
    -> [replica, ...]`` in slot order, each on its slot's device, the first
    the module itself, the others deep copies."""
    devs = [d for _, _, d in mesh.local_slots()]

    def place(module: torch.nn.Module) -> list:
        return [module.to(devs[0])] + [copy.deepcopy(module).to(d) for d in devs[1:]]

    return place


def shard_rows(x, mesh: Mesh, axis_name: str = "shard"):
    """(N, ...) rows split over the mesh's ``axis_name`` slots, N padded with
    zero rows to a multiple of the slot count (the reference's
    ``shard_rows``): (this process's pieces in slot order, each on its
    slot's device, N). Slot s takes rows [s·N_pad/S, (s+1)·N_pad/S)."""
    x = torch.as_tensor(x)
    n = int(x.shape[0])
    size = mesh.shape[axis_name]
    pad = (-n) % size
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
    per = x.shape[0] // size
    return [x[s * per:(s + 1) * per].to(d) for s, d in _axis_slots(mesh, axis_name)], n


class _GatherRows(torch.autograd.Function):
    """All processes' (n, D) rows in rank order, with gradients: the
    backward hands each process the gradient of its own rows. Every process
    computes the same loss of the gathered rows, so that slice is the whole
    gradient of its rows (no reduction over processes)."""

    @staticmethod
    def forward(ctx, x, group, rank: int, nproc: int):
        ctx.rank, ctx.n = rank, x.shape[0]
        cdev = _comm_device(group)
        xc = x.detach().to(cdev).contiguous()
        out = [torch.empty_like(xc) for _ in range(nproc)]
        dist.all_gather(out, xc, group=group)
        return torch.cat(out).to(x.device)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.n
        return grad[lo:lo + ctx.n], None, None, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``x`` of every process concatenated in rank order (equal shapes),
    differentiable (``_GatherRows``); ``x`` itself with one process. Under
    gloo the rows cross through host memory."""
    if mesh.group is None:
        return x
    return _GatherRows.apply(x, mesh.group, mesh.rank, mesh.nproc)


def all_reduce_sum(ts: list[torch.Tensor], mesh: Mesh) -> list[torch.Tensor]:
    """The elementwise sums over processes of ``ts`` (one flat buffer, one
    ``all_reduce``; under gloo through host memory), on the tensors' own
    devices; ``ts`` itself with one process. Every process gets the same
    sums."""
    if mesh.group is None:
        return ts
    flat = torch.cat([t.reshape(-1) for t in ts]).to(_comm_device(mesh.group))
    dist.all_reduce(flat, group=mesh.group)
    out, lo = [], 0
    for t in ts:
        out.append(flat[lo:lo + t.numel()].view_as(t).to(t.device))
        lo += t.numel()
    return out
