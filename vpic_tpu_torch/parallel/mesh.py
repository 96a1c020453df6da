"""One process per rank: the mp/MPI layer (src/util/mp/) over
torch.distributed (counterpart of ``vpic_tpu/parallel/mesh.py``).

The JAX package runs every shard of a decomposed grid in one program under
``shard_map`` and writes its exchanges as ``lax.ppermute`` / ``psum``.  Here
each rank of the topology is a process of its own, as in VPIC's MPI model;
its state is what a JAX shard holds (the leading ``(px, py, pz)`` dims
squeezed away), and each collective of the JAX step is a call on the
process's ``Mesh`` at the same place:

* ``ppermute(x, pairs)``: every rank that is a source in ``pairs`` sends
  ``x`` to its destinations, and a rank that is a destination gets its
  source's ``x`` (zeros elsewhere), as ``lax.ppermute``.  All ranks make the
  same calls in the same order; one call is one ``batch_isend_irecv``.
* ``all_sum``: ``dist.all_reduce``.
* ``gather_to_root`` / ``scatter_from_root``: checkpoints and dumps.

Flat ranks are x-major and z-minor (``grid.rank_coords``).  The process
group's transport is chosen by one rule and never switched:

* ``nccl``: CUDA tensors, one GPU per rank (``cuda:{LOCAL_RANK}``);
* ``gloo``: CPU tensors;
* ``gloo-staged``: CUDA tensors with more ranks than GPUs (one card shared
  by every rank, ``cuda:0``): NCCL refuses two ranks on one device and Gloo
  sends only host tensors, so each exchanged buffer is copied to pinned host
  memory, sent by Gloo and copied back.  ``staged_bytes`` counts the bytes
  copied each way and ``host_syncs`` the device-to-host copies (each waits
  for the device).

``launch(fn, world, device)`` spawns ``world`` local ranks (start method
``spawn``; a ``FileStore`` in a temporary directory, no TCP port), runs
``fn(*args)`` on each with its mesh current, and returns the ranks' results.
Under ``torchrun`` a deck calls ``init()`` (``__main__`` does), which reads
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``.  A failed ``init_process_group``
or a failed rank raises.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TRANSPORTS = ("nccl", "gloo", "gloo-staged", "local")

_CURRENT: Optional["Mesh"] = None


class Mesh:
    """This process's rank of a decomposed run: ``rank`` of ``world``, the
    ``device`` its tensors live on and the ``transport`` of its collectives
    ("local": a rank without a process group, for shard-local work such as
    a push; its collectives raise)."""

    def __init__(self, rank: int, world: int, device, transport: str):
        if transport not in TRANSPORTS:
            raise ValueError(f"transport {transport!r} not in {TRANSPORTS}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} of {world}")
        self.rank = int(rank)
        self.world = int(world)
        self.device = torch.device(device)
        self.transport = transport
        # bytes copied through host memory by gloo-staged (both ways), and
        # the device-to-host copies and reads the collectives made
        self.staged_bytes = 0
        self.host_syncs = 0
        self._seq = 0

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, world={self.world}, "
                f"device={self.device}, transport={self.transport})")

    # ---------------- wire format ----------------

    def _need_group(self):
        if self.transport == "local":
            raise RuntimeError(
                f"{self}: a collective needs a process group (mesh.init or "
                "mesh.launch)")

    def _staged(self, t: torch.Tensor) -> bool:
        return self.transport == "gloo-staged" and t.is_cuda

    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the transport sends it."""
        t = t.contiguous()
        if self._staged(t):
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.staged_bytes += h.numel() * h.element_size()
            self.host_syncs += 1
            return h
        if self.transport == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def _inbox(self, like: torch.Tensor, shape=None) -> torch.Tensor:
        shape = like.shape if shape is None else shape
        if self._staged(like):
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        dev = self.device if self.transport == "nccl" else like.device
        return torch.empty(shape, dtype=like.dtype, device=dev)

    def _back(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A received tensor on ``like``'s device."""
        if self._staged(like):
            self.staged_bytes += h.numel() * h.element_size()
            return h.to(like.device, non_blocking=True)
        return h.to(like.device)

    # ---------------- collectives ----------------

    def _tag(self, k: int = 0) -> int:
        """A tag for message k of the call being made (every rank makes the
        same calls in the same order, so the tags agree)."""
        return (self._seq * 8 + k) & 0x3FFFFFFF

    def ppermute(self, x, pairs: Sequence[Tuple[int, int]]):
        """``lax.ppermute`` over flat ranks: ``x`` (a tensor, or a list of
        tensors of one dtype, sent as one message) goes from each pair's
        source to its destination; returns what this rank received, zeros
        where it is no destination.  Every rank makes the call."""
        single = isinstance(x, torch.Tensor)
        xs = [x] if single else list(x)
        self._seq += 1
        outs = self._exchange(xs, [d for s, d in pairs if s == self.rank],
                              [s for s, d in pairs if d == self.rank])
        return outs[0] if single else outs

    def _exchange(self, xs: List[torch.Tensor], dsts, srcs):
        if len(srcs) > 1:
            raise ValueError(f"rank {self.rank} receives from {srcs}")
        outs = [torch.zeros_like(t) for t in xs]
        if not dsts and not srcs:
            return outs
        self._need_group()
        flat = torch.cat([t.reshape(-1) for t in xs]) if len(xs) > 1 \
            else xs[0].reshape(-1)
        ops, wire, inbox = [], None, None
        tag = self._tag()
        for d in dsts:
            if d == self.rank:
                continue
            if wire is None:
                wire = self._out(flat)
            ops.append(dist.P2POp(dist.isend, wire, d, tag=tag))
        got = None
        if srcs:
            if srcs[0] == self.rank:
                got = flat.clone()
            else:
                inbox = self._inbox(flat)
                ops.append(dist.P2POp(dist.irecv, inbox, srcs[0], tag=tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if inbox is not None:
            got = self._back(inbox, flat)
        if got is not None:
            off = 0
            for o in outs:
                o.copy_(got[off:off + o.numel()].view(o.shape))
                off += o.numel()
        return outs

    def exchange_rows(self, bufs: Sequence[torch.Tensor], n_send, n_recv,
                      dsts, srcs) -> List[torch.Tensor]:
        """Per face k, send rows ``bufs[k][:n_send[k]]`` to ``dsts[k]``
        and receive ``n_recv[k]`` rows from ``srcs[k]`` (-1: none), all in
        one batch; host ints.  Returns the received (n_recv[k], cols)
        tensors on the buffers' device."""
        self._seq += 1
        ops, inboxes = [], []
        for k, buf in enumerate(bufs):
            if dsts[k] >= 0 and n_send[k] > 0:
                ops.append(dist.P2POp(dist.isend, self._out(buf[:n_send[k]]),
                                      dsts[k], tag=self._tag(k)))
            if srcs[k] >= 0 and n_recv[k] > 0:
                box = self._inbox(buf, (n_recv[k],) + tuple(buf.shape[1:]))
                ops.append(dist.P2POp(dist.irecv, box, srcs[k],
                                      tag=self._tag(k)))
                inboxes.append((k, box))
        if ops:
            self._need_group()
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        out = [bufs[k][:0] for k in range(len(bufs))]
        for k, box in inboxes:
            out[k] = self._back(box, bufs[k])
        return out

    def exchange_counts(self, counts: Sequence[int], dsts, srcs) -> List[int]:
        """Per face k, send the host int ``counts[k]`` to ``dsts[k]`` and
        receive one from ``srcs[k]`` (-1: none; 0 then), in one batch."""
        self._seq += 1
        dev = self.device if self.transport == "nccl" else torch.device("cpu")
        ops, got = [], {}
        for k, c in enumerate(counts):
            if dsts[k] >= 0:
                ops.append(dist.P2POp(
                    dist.isend, torch.tensor([int(c)], dtype=torch.int64,
                                             device=dev), dsts[k],
                    tag=self._tag(k)))
            if srcs[k] >= 0:
                got[k] = torch.zeros(1, dtype=torch.int64, device=dev)
                ops.append(dist.P2POp(dist.irecv, got[k], srcs[k],
                                      tag=self._tag(k)))
        if ops:
            self._need_group()
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if got and dev.type == "cuda":
            self.host_syncs += 1
        return [int(got[k].item()) if k in got else 0
                for k in range(len(counts))]

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        self._need_group()
        t = self._out(x)
        if t is x or t.data_ptr() == x.data_ptr():
            t = x.clone()
        dist.all_reduce(t, op=op)
        return self._back(t, x)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``psum`` over every rank (mp_allsum): a new tensor on ``x``'s
        device."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The largest ``x`` of every rank, elementwise."""
        return self._reduce(x, dist.ReduceOp.MAX)

    def gather_to_root(self, x: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` (one shape on all ranks), in rank order, as
        CPU tensors on rank 0; None on the others."""
        self._need_group()
        t = self._out(x)
        box = [torch.empty_like(t) for _ in range(self.world)] \
            if self.rank == 0 else None
        dist.gather(t, box, dst=0)
        return None if box is None else [b.cpu() for b in box]

    def scatter_from_root(self, parts: Optional[Sequence[torch.Tensor]],
                          like: torch.Tensor) -> torch.Tensor:
        """Rank r gets ``parts[r]`` (given on rank 0, shaped as ``like``)
        on ``like``'s device."""
        self._need_group()
        box = self._inbox(like)
        src = None
        if self.rank == 0:
            src = [self._out(p.to(like.dtype).reshape(like.shape))
                   for p in parts]
        dist.scatter(box, src, src=0)
        return self._back(box, like)

    def broadcast_object(self, obj):
        """Rank 0's ``obj`` on every rank."""
        self._need_group()
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self):
        self._need_group()
        dist.barrier()


# ---------------- the process's mesh ----------------

def current() -> Optional[Mesh]:
    """The mesh this process runs as, or None."""
    return _CURRENT


def set_current(m: Optional[Mesh]):
    global _CURRENT
    _CURRENT = m


@contextlib.contextmanager
def use(m: Optional[Mesh]):
    """Run a block as rank ``m`` (e.g. ``Mesh(r, n, "cpu", "local")`` for
    shard-local work without a process group)."""
    prev = _CURRENT
    set_current(m)
    try:
        yield m
    finally:
        set_current(prev)


def rank_of(g) -> int:
    """This process's flat rank for grid ``g``: 0 on an undecomposed grid;
    on a decomposed one the current mesh's rank, which must have one rank
    for every domain."""
    if not g.sharded:
        return 0
    m = _CURRENT
    if m is None:
        raise RuntimeError(
            f"topology {g.topology} is decomposed: run one process per rank "
            "(vpic_tpu_torch.parallel.mesh.launch, or torchrun with "
            "mesh.init)")
    if m.world != g.n_shards:
        raise RuntimeError(f"topology {g.topology} needs {g.n_shards} ranks, "
                           f"the mesh has {m.world}")
    return m.rank


def mesh_of(g) -> Optional[Mesh]:
    """The current mesh on a decomposed grid (checked as in rank_of), None
    on an undecomposed one."""
    if not g.sharded:
        return None
    rank_of(g)
    return _CURRENT


def choose_transport(device, world: int, local_world: int = None,
                     local_rank: int = 0):
    """(device, transport) by the rule of the module docstring: CPU ->
    gloo; CUDA with a GPU for every local rank -> nccl on
    ``cuda:{local_rank}``; CUDA with fewer GPUs than local ranks ->
    gloo-staged on ``cuda:0``."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.device("cpu"), "gloo"
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("device 'cuda' but PyTorch sees no CUDA device")
    local_world = world if local_world is None else local_world
    if n >= local_world:
        return torch.device("cuda", local_rank), "nccl"
    return torch.device("cuda", 0), "gloo-staged"


def init(rank: int = None, world: int = None, device="cuda", store=None,
         local_rank: int = None, local_world: int = None) -> Mesh:
    """Join the process group and make this process's mesh current.
    Without ``rank``/``world`` they come from the torchrun environment
    (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE; the rendezvous from
    MASTER_ADDR/MASTER_PORT); ``store`` is a torch.distributed store (launch
    passes a FileStore)."""
    env = os.environ
    if rank is None:
        rank = int(env["RANK"])
        world = int(env["WORLD_SIZE"])
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev, transport = choose_transport(device, world, local_world, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if transport == "nccl" else "gloo"
    kw = dict(rank=rank, world_size=world)
    if store is not None:
        kw["store"] = store
    else:
        kw["init_method"] = "env://"
    dist.init_process_group(backend, **kw)
    # a first collective of every rank: NCCL's point-to-point batches then
    # need not be joined by all of them
    dist.barrier()
    m = Mesh(rank, world, dev, transport)
    set_current(m)
    return m


def finalize():
    """Leave the process group (every rank) and forget the mesh."""
    if dist.is_initialized():
        dist.destroy_process_group()
    set_current(None)


def _rank_main(rank, fn, world, device, tmp, args):
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    init(rank, world, device, store=store, local_rank=rank,
         local_world=world)
    try:
        out = fn(*args)
    finally:
        finalize()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)


def launch(fn, world: int, device="cuda", args=(), tmpdir=None) -> list:
    """Run ``fn(*args)`` on ``world`` local ranks, one spawned process each
    with its mesh current (``fn`` must be importable by name); returns the
    ranks' results in rank order.  The FileStore and the results go to a
    new directory under ``tmpdir`` (the system's by default), removed
    after.  Raises if any rank fails (the others are stopped)."""
    import torch.multiprocessing as mp
    tmp = tempfile.mkdtemp(prefix="vpic_mesh_", dir=tmpdir)
    try:
        mp.start_processes(_rank_main,
                           args=(fn, world, str(device), tmp, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------- the decomposed smoke run ----------------

def harris_case(n: int, device="cuda"):
    """One step of harris decomposed along y, (1, n, 1) (the reference
    harris deck's 1 x nproc x 1 topology): (rank's step, energies)."""
    from ..models import harris
    p = harris.HarrisParams(nx=8, ny=8 * n, nz=1, nppc=8, Lx=4.0,
                            Ly=4.0 * n, topology=(1, n, 1))
    sim = harris.build(p, device=device)
    state = sim.make_step()(sim.initialize())
    en = sim.energies(state)
    if not bool(torch.isfinite(en).all()):
        raise AssertionError("non-finite energies")
    return state.step, en.double().cpu().numpy()


def irregular_join_case(device="cuda"):
    """One step of an irregular domain graph (join_domain between ranks):
    a 4-rank x line spliced into two independent 2-rank periodic rings,
    64 lanes (vpic_tpu/parallel/mesh.py:120-145).  Returns the lanes this
    rank holds after the step."""
    from .. import deck as D
    sim = D.Simulation(seed=0, device=device)
    sim.define_units(1.0, 1.0)
    g0 = D.partition_periodic_box(0, 0, 0, 4.0, 1.0, 0.125, 32, 8, 1)
    sim.define_timestep(0.7 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (4.0, 1.0, 0.125), (32, 8, 1),
                             (4, 1, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    ele = sim.define_species("electron", -1.0, 1.0, 256)
    for i in range(64):
        sim.inject_particle(ele, 0.0625 * i + 0.03, 0.5, 0.0625, 0.5, 0.1,
                            0.0, w=1.0)
    sim.join_domain(3, 1, 0)
    sim.join_domain(3, 0, 1)
    sim.join_domain(3, 3, 2)
    sim.join_domain(3, 2, 3)
    state = sim.make_step()(sim.initialize())
    return int(state.species[0].np)


def reflux_case(device="cuda", n_steps: int = 1):
    """maxwellian_reflux on a decomposed face: each of the (1, 2, 1) ranks
    owns half of the low-x reflux wall, and the ranks' generators draw
    apart (vpic_tpu/parallel/mesh.py:181-207); 128 lanes.  Returns the
    lanes this rank holds after ``n_steps`` steps."""
    import numpy as np
    from .. import deck as D
    from ..boundary_ops import maxwellian_reflux
    from ..grid import BOUNDARY
    sim = D.Simulation(seed=3, device=device)
    sim.define_units(1.0, 1.0)
    gr = D.partition_periodic_box(0, 0, 0, 1.0, 2.0, 0.125, 16, 16, 1,
                                  1, 2, 1)
    sim.define_timestep(0.6 * gr.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 2.0, 0.125), (16, 16, 1),
                             topology=(1, 2, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 512, -1, 4, 1)
    rng = np.random.default_rng(1)
    for _ in range(128):
        sim.inject_particle(el, rng.uniform(0.02, 0.2),
                            rng.uniform(0.05, 1.95), 0.0625,
                            -abs(rng.normal(0, 0.8)), rng.normal(0, 0.3),
                            0.0, 1.0)
    sim.set_domain_particle_bc(BOUNDARY(-1, 0, 0),
                               maxwellian_reflux({"e": 0.3}, {"e": 0.3}))
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    return int(state.species[0].np)


def emitter_case(device="cuda"):
    """One step of the emission diode decomposed (2, 1, 1), nx = 32, ny = 8
    (vpic_tpu/parallel/mesh.py:147-157): each rank emits from its own
    brick's cathode faces.  Returns the lanes this rank holds after the
    step."""
    from ..models import emission
    sim = emission.build(emission.EmissionParams(topology=(2, 1, 1), nx=32,
                                                 ny=8), device=device)
    state = sim.make_step()(sim.initialize())
    return int(state.species[0].np)


def collisional_case(device="cuda", n_steps: int = 1):
    """``n_steps`` steps of the collisional reconnection deck decomposed
    (2, 1, 1), 16 x 8 x 1 cells, 8 ppc, three Takizuka-Abe ops firing
    every step (vpic_tpu/parallel/mesh.py:209-222).  Returns (the lanes
    the ranks hold, the lanes the deck staged, the energies every rank
    sums)."""
    from ..models import reconnection as RC
    sim = RC.build(RC.ReconnectionParams(
        nx=16, ny=8, nz=1, nppc=8, Lx=8.0, Ly=4.0, Lz=1.0,
        topology=(2, 1, 1), tau_coll_interval=1), device=device)
    state = sim.initialize()
    step = sim.make_step()
    for _ in range(n_steps):
        state = step(state)
    en = sim.energies(state)
    if not bool(torch.isfinite(en).all()):
        raise AssertionError("collisional (2, 1, 1): non-finite energies")
    from ..ops.fields import all_sum
    lanes = all_sum(torch.tensor(sum(int(sp.np) for sp in state.species),
                                 dtype=torch.float64), sim.grid)
    return (int(lanes), sum(st.count for st in sim.species),
            en.double().cpu().numpy())


def chart3d_case(device="cuda"):
    """One step of a 32^3 periodic box of 512 lanes on a full (2, 2, 2)
    decomposition, every axis decomposed (vpic_tpu/parallel/mesh.py:153-176,
    where it runs the 3-D brick-chart kernel; here the 3-D push with home
    maps, "push3d").  Returns (this rank's lanes, the path, the energies
    every rank sums)."""
    import numpy as np
    from .. import deck as D
    sim = D.Simulation(seed=2, device=device)
    sim.define_units(1.0, 1.0)
    n = 32
    g = D.partition_periodic_box(0, 0, 0, 1, 1, 1, n, n, n, 2, 2, 2)
    sim.define_timestep(0.6 * g.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1, 1, 1), (n, n, n),
                             topology=(2, 2, 2))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    el = sim.define_species("e", -1.0, 1.0, 8192, -1, 4, 1)
    rng = np.random.default_rng(0)
    for _ in range(512):
        sim.inject_particle(el, *rng.uniform(0.01, 0.99, 3),
                            *rng.normal(0, 0.3, 3), 1.0)
    step = sim.make_step()
    state = step(sim.initialize())
    en = sim.energies(state)
    if not bool(torch.isfinite(en).all()):
        raise AssertionError("(2, 2, 2) 3-D: non-finite energies")
    return int(state.species[0].np), step.path, en.double().cpu().numpy()


def _two_rank_cases(device):
    """The dry run's two-rank cases, one launch: the decomposed reflux, the
    emitter and the collisional deck."""
    return dict(reflux=reflux_case(device), emitter=emitter_case(device),
                collisional=collisional_case(device))


def _dryrun_rank(n: int, device):
    out = {"harris": harris_case(n, device)}
    if n == 8:
        out["chart3d"] = chart3d_case(device)
    return out


def dryrun(n: int, device="cuda") -> None:
    """One decomposed step on local ranks of each case the JAX package's
    dry run has (vpic_tpu/parallel/mesh.py:78-222) but its 2-D brick
    chart (not ported): harris (1, n, 1) on n ranks; for n >= 4 the
    irregular join on 4; for n >= 8 the (2, 2, 2) 3-D box on 8; and on 2
    the decomposed reflux, the surface emitter (2, 1, 1) and the
    collisional deck (2, 1, 1).  Raises where a case fails its check: a
    lane lost, nothing emitted, non-finite energies."""
    res = launch(_dryrun_rank, n, device, args=(n, str(device)))
    en = res[0]["harris"][1]
    print(f"dryrun({n}): ok, step={res[0]['harris'][0]}, energies={en}")
    if n >= 4:
        kept = sum(launch(irregular_join_case, 4, device,
                          args=(str(device),)))
        if kept != 64:
            raise AssertionError(f"irregular join kept {kept} of 64 lanes")
        print(f"dryrun({n}): irregular-join ok")
    if n >= 8:
        r3 = [r["chart3d"] for r in res] if n == 8 else \
            launch(chart3d_case, 8, device, args=(str(device),))
        kept = sum(r[0] for r in r3)
        if kept != 512:
            raise AssertionError(f"(2, 2, 2) 3-D kept {kept} of 512 lanes")
        print(f"dryrun({n}): (2,2,2) 3-D ok (path {r3[0][1]})")
    two = launch(_two_rank_cases, 2, device, args=(str(device),))
    kept = sum(r["reflux"] for r in two)
    if kept != 128:
        raise AssertionError(f"reflux kept {kept} of 128 lanes")
    print(f"dryrun({n}): sharded-reflux ok")
    emitted = sum(r["emitter"] for r in two)
    if not emitted > 0:
        raise AssertionError("decomposed emitter emitted nothing")
    print(f"dryrun({n}): sharded-emitter ok ({emitted} emitted)")
    lanes, staged, en = two[0]["collisional"]
    if lanes != staged:
        raise AssertionError(f"collisional (2, 1, 1): {staged} lanes "
                             f"staged, {lanes} held")
    print(f"dryrun({n}): sharded-collisional (2,1,1) ok, energies={en}")
