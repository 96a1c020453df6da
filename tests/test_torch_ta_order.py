"""The Takizuka-Abe op's order pass, as its plain twin
(vpic_tpu_torch/ops/ta_collide.py::shuffle_order_ref, the spec the kernels
of csrc/ta_collide.cu implement), against the plain op's shuffle_sort and
cell_partition, bit for bit; and the op's route and the kernel wrappers'
checks, on the CPU.  The kernels themselves run in
tests/test_torch_cuda_ta.py on the card."""

import pytest
import torch

import vpic_tpu_torch.collision as C
import vpic_tpu_torch.ops.ta_collide as TA
from vpic_tpu_torch.grid import partition_periodic_box
from vpic_tpu_torch.scripts import stochastic_checks as SC
from vpic_tpu_torch.state import SpeciesState

torch.set_num_threads(2)


def lanes(n, nv, seed, dead=0.0):
    """(live, vox, key) of n slots over interior and ghost voxels, each
    slot dead with probability ``dead``, the keys drawn as a shuffle's."""
    gen = torch.Generator().manual_seed(seed)
    vox = torch.randint(0, nv, (n,), generator=gen, dtype=torch.int32)
    live = torch.rand(n, generator=gen) >= dead
    return live, vox, C.shuffle_bits(gen, n, "cpu")


def equal_keys(nv):
    live, vox, key = lanes(3000, nv, 1, dead=0.2)
    vox[::3] = 17
    key[vox == 17] = 12345
    key[500:900] = 0
    return live, vox, key


def holes(nv):
    live, vox, key = lanes(4096, nv, 2)
    live[1000:1500] = False
    live[2000:4096:3] = False
    return live, vox, key


def all_dead(nv):
    live, vox, key = lanes(5000, nv, 3)
    return torch.zeros_like(live), vox, key


def empty_voxels(nv):
    live, vox, key = lanes(2500, nv, 4, dead=0.1)
    return live, vox % 9 * 11, key


def over_cap(nv):
    # one voxel with more live lanes than a segment ranks on chip, their
    # keys' top bits equal so that they share a segment
    live, vox, key = lanes(3000, nv, 5, dead=0.1)
    vox[:2400] = 40
    live[:2400] = True
    key[:2400] >>= 8
    return live, vox, key


def none_wide(live, vox):
    return 0, 0


def voxel_40_wide(live, vox):
    return int((live & (vox == 40)).sum()), 0


@pytest.mark.parametrize("case, wide", [
    (equal_keys, none_wide), (holes, none_wide), (all_dead, none_wide),
    (empty_voxels, none_wide), (over_cap, voxel_40_wide)])
def test_order_twin_is_shuffle_sort(case, wide):
    g = partition_periodic_box(0, 0, 0, 1, 1, 1, 4, 4, 4)
    live, vox, key = case(g.nv)
    n = live.shape[0]
    sp = SpeciesState(dx=torch.zeros(n), dy=torch.zeros(n),
                      dz=torch.zeros(n), i=vox, ux=torch.zeros(n),
                      uy=torch.zeros(n), uz=torch.zeros(n), w=torch.ones(n),
                      live=live, np=live.sum(dtype=torch.int32))
    shuffled, perm = C.shuffle_sort(sp, key)
    start, count = C.cell_partition(shuffled, g)
    got, wide_lanes = TA.shuffle_order_ref(live, vox, key, g.nv)
    first, cnt = TA.voxel_partition(got, g.nv)
    assert torch.equal(got.order.long(), perm)
    assert torch.equal(first.long(), start)
    assert torch.equal(cnt.long(), count)
    assert wide_lanes == wide(live, vox)


def _route_op(name):
    g = SC.collision_grid(4)
    n = 512
    ops = SC.collision_ops(g, n)
    sp = [SC.collision_species(n, g, seed=0),
          SC.collision_species(n, g, seed=1)]
    op = ops[name]
    op.apply(sp, g, op.draw(torch.Generator().manual_seed(0), sp))
    return op.route


def _bad_dtype():
    live, vox, key = lanes(64, 27, 0)
    TA.shuffle_order(live, vox, key.float(), 27)


def _strided():
    live, vox, key = lanes(128, 27, 0)
    TA.shuffle_order(live[::2], vox[::2], key[::2], 27)


def _cpu():
    live, vox, key = lanes(64, 27, 0)
    TA.shuffle_order(live, vox, key, 27)


def _collide_cpu():
    g = SC.collision_grid(2)
    sp = SC.collision_species(64, g)
    key = torch.zeros(64, dtype=torch.int32)
    o, _ = TA.shuffle_order_ref(sp.live, sp.i, key, g.nv)
    d = {k: torch.zeros(32) for k in ("pr", "phi", "theta", "bal")}
    TA.collide(sp, o, None, None, d,
               TA.Constants(0.1, 1.0, 1.0, 1.0, 0.5, 0.5, 6.28))


@pytest.mark.parametrize("what, expect", [
    ("takizuka_abe", "plain"), ("takizuka_abe_inter", "plain"),
    ("hard_sphere", "plain"), ("large_angle_coulomb", "plain"),
    (_bad_dtype, (TypeError, "key has dtype")),
    (_strided, (ValueError, "not contiguous")),
    (_cpu, (ValueError, "CUDA tensors")),
    (_collide_cpu, (ValueError, "CUDA tensors"))])
def test_route_and_wrapper_checks(what, expect):
    if isinstance(what, str):
        assert _route_op(what) == expect
        return
    err, msg = expect
    with pytest.raises(err, match=msg):
        what()

