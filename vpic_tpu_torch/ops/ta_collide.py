"""The Takizuka-Abe binary op's hand-written CUDA kernels
(``csrc/ta_collide.cu``), which ``collision.make_binary_op`` runs for a
T&A model on CUDA tensors; the plain op (``collision.py``) serves the CPU
and every other model, and is the reference the card tests hold this to.

An op is an order pass for each species it shuffles (:func:`shuffle_order`:
six launches, after a zeroing) and one pair kernel (:func:`collide`).  The
order pass gives ``collision.shuffle_sort``'s permutation bit for bit and
``collision.cell_partition``'s voxel starts, by segments: a live lane's
voxel split by its key's top ``sub`` bits, then the dead lanes split by
their key's top ``dead`` bits (:func:`segment_bits`); a segment of more
than ``CAP`` lanes takes the kernels' wide path, decided on the device, and
its lanes add to the wide counts (:func:`wide_lanes`: device counters
written through to mapped host memory, as ``residency.rebuckets_by_cause``
reads its own).  :func:`shuffle_order_ref` is the plain twin of the order
pass, the spec the kernels implement.

Nothing here reads the device on the host: the ops add no synchronization
to a step, and a firing is captured in the step's CUDA graph."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..state import SpeciesState
from . import _build
from .fused_push import c_array

KERNEL = "ta_collide"
# as csrc/ta_collide.cu has them: the lanes of a segment its rank pass
# sorts on chip (a larger one takes the wide path), the segments a block of
# its scan takes, and the launches of an order pass
CAP = 1024
SCAN_TILE = 1024
ORDER_LAUNCHES = 6
# a segment's lanes at most on average with every slot live, and a dead
# bucket's with every slot dead (segment_bits)
SEG_LANES = 16
DEAD_LANES = 64

# Kernel launches made since the count was last reset.
launches = 0
# on the card, per device index: (the wide counts' device counters, the
# address of their mapped host copy, a view of that copy)
_card_wide: dict = {}


class Order(NamedTuple):
    """An order pass's result: ``order`` (n,) int32, place -> slot;
    ``start`` (nseg + 1,) int32, each segment's first place; ``sub``, the
    sub-bucket bits (voxel v's live lanes are places
    [start[v << sub], start[(v + 1) << sub]))."""
    order: torch.Tensor
    start: torch.Tensor
    sub: int


def segment_bits(n: int, nv: int):
    """(sub, dead): a voxel's lanes split into 2**sub segments by their
    key's top bits, so that a segment holds SEG_LANES lanes or fewer on
    average with every slot of the ``n`` live among ``nv`` voxels; the dead
    lanes into 2**dead buckets of DEAD_LANES or fewer with every slot
    dead."""
    sub = max(0, -(-n // (SEG_LANES * nv)) - 1).bit_length()
    dead = max(0, -(-n // DEAD_LANES) - 1).bit_length()
    return sub, dead


def segment_ref(live, vox, key, nv: int, sub: int, dead: int):
    """Each lane's segment (int64): the kernels' ``segment``."""
    k = key.long()
    live_seg = (vox.long() << sub) | ((k >> (31 - sub)) & ((1 << sub) - 1))
    dead_seg = (nv << sub) + ((k >> (31 - dead)) & ((1 << dead) - 1))
    return torch.where(live, live_seg, dead_seg)


def shuffle_order_ref(live, vox, key, nv: int):
    """The plain twin of the order pass on any device: (Order, the wide
    lanes (live, dead) as the kernels count them).  Lanes are counted by
    segment, the counts' exclusive scan gives each segment's first place,
    and a lane's place in its segment is the count of its segment's lanes
    with a smaller (key, slot).  Compares each lane with every other, 1024
    lanes at a time: a spec for tests, not for large species."""
    chunk = 1024
    n = live.shape[0]
    sub, dead = segment_bits(n, nv)
    nseg = (nv << sub) + (1 << dead)
    seg = segment_ref(live, vox, key, nv, sub, dead)
    count = torch.bincount(seg, minlength=nseg)
    start = torch.zeros(nseg + 1, dtype=torch.int64, device=live.device)
    start[1:] = torch.cumsum(count, 0)
    slot = torch.arange(n, device=live.device)
    sort_key = (key.long() << 32) | slot
    place = torch.empty(n, dtype=torch.int64, device=live.device)
    for c0 in range(0, n, chunk):
        c = slice(c0, c0 + chunk)
        below = (seg[c, None] == seg[None, :]) & \
            (sort_key[None, :] < sort_key[c, None])
        place[c] = start[seg[c]] + below.sum(1)
    order = torch.empty(n, dtype=torch.int32, device=live.device)
    order[place] = slot.to(torch.int32)
    return Order(order, start.to(torch.int32), sub), \
        _wide(count, nv << sub)


def _wide(count, dead0: int):
    wide = torch.where(count > CAP, count, 0)
    return int(wide[:dead0].sum()), int(wide[dead0:].sum())


def wide_ref(live, vox, key, nv: int):
    """(live, dead) lanes of an order pass's segments of more than CAP
    lanes, the lanes its wide path takes."""
    sub, dead = segment_bits(live.shape[0], nv)
    seg = segment_ref(live, vox, key, nv, sub, dead)
    return _wide(torch.bincount(seg, minlength=(nv << sub) + (1 << dead)),
                 nv << sub)


def voxel_partition(o: Order, nv: int):
    """(start[voxel], count[voxel]) of an order pass's live lanes, as
    ``collision.cell_partition`` gives them (int32)."""
    first = o.start[torch.arange(nv + 1, device=o.start.device) << o.sub]
    return first[:-1], first[1:] - first[:-1]


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    if lib.ta_order.argtypes is None:
        lib.ta_order.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.c_void_p]
        lib.ta_order.restype = ctypes.c_int
        lib.ta_pair.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_int),
                                ctypes.POINTER(ctypes.c_float),
                                ctypes.c_void_p]
        lib.ta_pair.restype = ctypes.c_int
        lib.ta_collide_host_counts.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_void_p)]
        lib.ta_collide_host_counts.restype = ctypes.c_int
        lib.ta_collide_error_string.argtypes = [ctypes.c_int]
        lib.ta_collide_error_string.restype = ctypes.c_char_p
    return lib


def _raise(lib, what: str, rc: int):
    msg = lib.ta_collide_error_string(rc).decode()
    raise RuntimeError(f"{what} failed: {msg} ({rc})")


def _wide_counters(dev: torch.device):
    """(device counters, device address of their host copy) on ``dev``,
    made at the first order pass there (not while a graph is captured: the
    graphed step runs each cadence eagerly first)."""
    if dev.index not in _card_wide:
        lib = _lib()
        host, mapped = ctypes.c_void_p(), ctypes.c_void_p()
        rc = lib.ta_collide_host_counts(2, ctypes.byref(host),
                                        ctypes.byref(mapped))
        if rc != 0:
            _raise(lib, "ta_collide_host_counts", rc)
        _card_wide[dev.index] = (
            torch.zeros(2, dtype=torch.int64, device=dev), mapped.value,
            (ctypes.c_int64 * 2).from_address(host.value))
    return _card_wide[dev.index][:2]


def wide_lanes() -> dict:
    """{"live": lanes, "dead": lanes} that took the order pass's wide path
    (segments of more than CAP lanes) in this process, on every device: the
    mapped host copies as the device has written them so far, exact once
    its work is done (after a synchronize)."""
    live = sum(h[0] for _, _, h in _card_wide.values())
    dead = sum(h[1] for _, _, h in _card_wide.values())
    return {"live": live, "dead": dead}


def _check(t: torch.Tensor, name: str, dtype, n: int, dev: torch.device):
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"({n},)")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")


def _cuda(dev: torch.device, what: str):
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA tensors, not {dev} (the "
                         "plain op serves the CPU)")


def shuffle_order(live, vox, key, nv: int) -> Order:
    """``collision.shuffle_sort``'s permutation of a species (``live``
    bool, ``vox`` int32, ``key`` the shuffle's 31-bit int32 keys, all (n,)
    and contiguous on one CUDA device) and its voxel starts, in six
    launches of csrc/ta_collide.cu.  Keys must lie in [0, 2**31) and live
    voxels in [0, nv): nothing is checked on the device."""
    global launches
    n = live.shape[0]
    dev = live.device
    for t, name, dtype in ((live, "live", torch.bool),
                           (vox, "vox", torch.int32),
                           (key, "key", torch.int32)):
        _check(t, name, dtype, n, dev)
    _cuda(dev, "shuffle_order")
    sub, dead = segment_bits(n, nv)
    nseg = (nv << sub) + (1 << dead)
    if n >= 2 ** 31 or nseg >= 2 ** 31 - 1:
        raise NotImplementedError(f"shuffle_order: {n} lanes and {nseg} "
                                  "segments are past the kernels' int32")
    ntiles = -(-nseg // SCAN_TILE)
    nwide = n // (CAP + 1) + 1
    i32 = torch.int32
    zeroed = torch.zeros(nseg + 1, dtype=i32, device=dev)
    count, wide_n = zeroed[:nseg], zeroed[nseg:]
    scratch = torch.empty(ntiles + nseg + nwide + n, dtype=i32, device=dev)
    tile_sum, fill, wide_seg, seg_of = torch.split(
        scratch, [ntiles, nseg, nwide, n])
    tmp = torch.empty(n, dtype=torch.int64, device=dev)
    start = torch.empty(nseg + 1, dtype=i32, device=dev)
    order = torch.empty(n, dtype=i32, device=dev)
    wide, wide_host = _wide_counters(dev)
    ptrs = [t.data_ptr() for t in (live, vox, key, count, wide_n, tile_sum,
                                   start, fill, wide_seg, tmp, seg_of, order,
                                   wide)] + [wide_host]
    ints = [n, nv, sub, dead, nseg, ntiles, nwide]
    lib = _lib()
    rc = lib.ta_order(c_array(ctypes.c_void_p, ptrs),
                      c_array(ctypes.c_int, ints),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, "ta_order", rc)
    launches += ORDER_LAUNCHES
    return Order(order, start, sub)


class Constants(NamedTuple):
    """The op's scalars, each cast to float32 by the kernel's caller as
    torch casts a Python number it multiplies a float32 tensor by:
    ``dtint_dv`` dt interval / dV, ``sample``, ``cvac``, ``var_c`` T&A's
    sigma^2 v_r^3, ``fi`` and ``fj`` mu / m_i and mu / m_j, ``two_pi``."""
    dtint_dv: float
    sample: float
    cvac: float
    var_c: float
    fi: float
    fj: float
    two_pi: float


_LANES = ("dx", "dy", "dz", "ux", "uy", "uz", "w", "i", "live")
_DRAWS = ("pr", "phi", "theta", "bal")


def _species_check(sp: SpeciesState, name: str, dev):
    n = sp.capacity
    for col in _LANES:
        dtype = (torch.int32 if col == "i" else
                 torch.bool if col == "live" else torch.float32)
        _check(getattr(sp, col), f"{name}.{col}", dtype, n, dev)


def _empty_like(sp: SpeciesState) -> SpeciesState:
    """New columns for sp's rows, ``np`` sp's."""
    return sp.replace(**{c: torch.empty_like(getattr(sp, c)) for c in _LANES})


def collide(si: SpeciesState, oi: Order, sj: Optional[SpeciesState],
            oj: Optional[Order], draws: dict, c: Constants):
    """One T&A pairing round in one launch of csrc/ta_collide.cu: species
    ``si`` (and ``sj`` between species; None within one) read through
    their order passes, collided with ``draws`` (``pr``, ``phi``,
    ``theta``, ``bal``: (n_i // 2,) within a species, (n_i,) between) and
    written in the shuffled order to new tensors.  Returns the new si, or
    (si, sj) between species; ``np`` is the input's."""
    global launches
    intra = sj is None
    dev = si.ux.device
    _species_check(si, "si", dev)
    ni = si.capacity
    _check(oi.order, "order_i", torch.int32, ni, dev)
    nd = ni // 2 if intra else ni
    for k in _DRAWS:
        _check(draws[k], k, torch.float32, nd, dev)
    if not intra:
        _species_check(sj, "sj", dev)
        _check(oj.order, "order_j", torch.int32, sj.capacity, dev)
    _cuda(dev, "collide")
    out_i = _empty_like(si)
    out_j = None if intra else _empty_like(sj)
    null = [0] * len(_LANES)
    cols = lambda sp: null if sp is None else \
        [getattr(sp, col).data_ptr() for col in _LANES]
    lanes = cols(si) + cols(sj) + cols(out_i) + cols(out_j)
    ptrs = [oi.order.data_ptr(), 0 if intra else oj.order.data_ptr(),
            oi.start.data_ptr(), 0 if intra else oj.start.data_ptr()] + \
        [draws[k].data_ptr() for k in _DRAWS]
    ints = [ni, 0 if intra else sj.capacity, oi.sub,
            0 if intra else oj.sub, int(intra)]
    lib = _lib()
    rc = lib.ta_pair(c_array(ctypes.c_void_p, lanes),
                     c_array(ctypes.c_void_p, ptrs),
                     c_array(ctypes.c_int, ints),
                     c_array(ctypes.c_float, list(c)),
                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, "ta_pair", rc)
    launches += 1
    return out_i if intra else (out_i, out_j)
