"""The step's field advance (``Simulation.field_advance``): the fused
field_beb kernel on every deck it covers, the plain trio, with the reasons,
on the rest.  On the CPU the fused trio runs its plain version
(ops/field_fuse.beb_ref: the same three calls in the same order), so the
step stays bit for bit what the three plain calls give.  The step runs the
kernel's grid instance; which grids the cluster instance takes is decided
by bytes alone, in pure Python, so it is checked here; both instances
against the plain trio are on the card (tests/test_torch_cuda_protos.py).  Its parity with vpic_tpu's Pallas
prototype is tests/test_torch_field_fuse.py."""

import dataclasses

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.ops.fields as F
from vpic_tpu_torch.models import (emission, harris, lpi, reconnection,
                                   shapes, weibel)

torch.set_num_threads(2)

SMALL3 = dict(nx=16, ny=16, nz=16, nppc=2, Lx=8.0, Ly=8.0, Lz=8.0,
              headroom=6.0)

DECKS = {
    "harris2d": lambda: harris.build(harris.HarrisParams(
        nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0), device="cpu"),
    "harris3d": lambda: harris.build(harris.HarrisParams(**SMALL3),
                                     device="cpu"),
    "reconnection": lambda: reconnection.build(
        reconnection.ReconnectionParams(nx=8, ny=8, nz=8, nppc=1, Lx=4.0,
                                        Ly=4.0, Lz=4.0), device="cpu"),
    "weibel": lambda: weibel.build(weibel.WeibelParams(nx=8, ny=8, nppc=1),
                                   device="cpu"),
    "emission": lambda: emission.build(emission.EmissionParams(
        nx=8, ny=4, capacity=256), device="cpu"),
    "lpi": lambda: lpi.build(lpi.LPIParams(nx=16, ny=8, nppc=1),
                             device="cpu"),
    "shapes": lambda: shapes.build(shapes.ShapesParams(nx=16, ny=8),
                                   device="cpu"),
}
PLAIN = {
    "lpi": ("user_field_injection runs between advance_e and the second "
            "advance_b", "face 0 is absorbing"),
    "shapes": ("is a mesh array",),
}


@pytest.mark.parametrize("deck", sorted(DECKS))
def test_make_advance_picks_the_field_advance(deck):
    adv = DECKS[deck]().make_advance()
    if deck in PLAIN:
        assert adv.fields.startswith("plain: ")
        for why in PLAIN[deck]:
            assert why in adv.fields, adv.fields
    else:
        assert adv.fields == "field_beb"


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


@pytest.mark.parametrize("deck", ["harris2d", "harris3d"])
def test_step_fields_bit_for_bit_the_plain_calls(deck, monkeypatch):
    """10 steps through the step with field_beb against 10 steps from the
    same state with the three plain calls written out by hand in its
    place: fields and lanes bit for bit, and the fused trio called once a
    step."""
    sim = DECKS[deck]()
    hand = DECKS[deck]()
    g, m, damp = hand.grid, hand._material_coeffs(), hand.damp

    def by_hand(f, step):
        F.advance_b(f, g, 0.5)
        F.advance_e(f, g, m, damp)
        F.advance_b(f, g, 0.5)
        return f

    hand.field_advance = lambda: (by_hand, "by hand")
    calls = []
    ref = FF.beb_ref
    monkeypatch.setattr(FF, "beb_ref",
                        lambda *a: calls.append(1) or ref(*a))
    s0 = sim.initialize()
    h0 = hand.initialize()
    step, hstep = sim.make_step(), hand.make_step()
    assert step.fields == "field_beb" and hstep.fields == "by hand"
    a, b = s0, h0
    for _ in range(10):
        a, b = step(a), hstep(b)
    assert len(calls) == 10
    for n in FF.FIELDS + ("rhob",):
        assert torch.equal(_bits(getattr(a.fields, n)),
                           _bits(getattr(b.fields, n))), n
    for sa, sb in zip(a.species, b.species):
        for n in ("dx", "dy", "dz", "i", "ux", "uy", "uz", "w", "live"):
            assert torch.equal(_bits(getattr(sa, n)),
                               _bits(getattr(sb, n))), n
    assert np.isfinite(sim.energies(a).numpy()).all()


@pytest.mark.parametrize("cells,which", [
    ((64, 64, 1), "cluster"), ((128, 128, 1), "cluster"),
    ((32, 32, 32), "cluster"), ((37, 23, 11), "cluster"),
    ((16, 16, 1), "cluster"), ((5, 4, 3), "cluster"),
    ((256, 256, 1), "grid"), ((64, 64, 64), "grid"),
    ((48, 48, 48), "grid"), ((1024, 1, 1), "cluster")])
def test_instance_choice_by_bytes(cells, which):
    """Where the cluster instance takes a grid (its slabs fit), and how it
    cuts the grid."""
    assert FF.cluster_fits(cells) == (which == "cluster")
    plan = FF.cluster_plan(cells)
    N = [c + 2 for c in cells]
    assert plan.axis == max([a for a in range(3) if N[a] > 3], default=0)
    # every plane lies in one slab, no CTA is empty, and a CTA's six arrays
    # hold its slab with the 16-byte alignment shift
    np_ = N[plan.axis]
    lo = [r * np_ // plan.ctas for r in range(plan.ctas + 1)]
    rows = [b - a for a, b in zip(lo, lo[1:])]
    assert min(rows) >= 1 and max(rows) == plan.rows
    assert plan.rs >= plan.rows * plan.inner
    assert (plan.rs - np_ * plan.inner) % 4 == 0
    assert plan.stride % 4 == 0 and plan.stride >= 3 + plan.outer * plan.rs
    assert plan.inner * np_ * plan.outer == N[0] * N[1] * N[2]
    assert (plan.smem <= FF.SMEM_PER_CTA) == (which == "cluster")
    if which == "cluster":
        # one cluster holds the 12 arrays of the whole grid
        assert 48 * N[0] * N[1] * N[2] <= FF.CLUSTER_CTAS * FF.SMEM_PER_CTA


def test_make_beb_takes_an_instance():
    sim = DECKS["harris2d"]()
    g, m = sim.grid, sim._material_coeffs()
    assert FF.make_beb(g, m, sim.damp).instance == "grid"
    assert FF.make_beb(g, m, sim.damp, "cluster").instance == "cluster"
    with pytest.raises(ValueError):
        FF.make_beb(g, m, sim.damp, "warp")
    big = GT.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, 256, 256, 1,
                                    dt=0.01, cvac=1.0, eps0=1.0)
    assert FF.make_beb(big, m, 0.0).instance == "grid"
    with pytest.raises(ValueError, match="cluster instance needs"):
        FF.make_beb(big, m, 0.0, "cluster")


def test_kernel_args_pack_the_plain_coefficients():
    """The kernel's 17 coefficients and 12 face ints: the plain ops'
    float32 values (0 along the flat axis), pec flags on harris's x
    faces, a wrap rule on its periodic ones."""
    sim = DECKS["harris2d"]()
    g, m, damp = sim.grid, sim._material_coeffs(), sim.damp
    coef, faces = FF.kernel_args(g, m, damp)
    coef, faces = list(coef), list(faces)
    assert len(coef) == 17 and len(faces) == 12
    f32 = lambda x: float(np.float32(x))
    assert coef[0] == f32(0.5 * g.cvac * g.dt * g.rdx)
    assert coef[3] == f32((1 + damp) * g.cvac * g.dt * g.rdx)
    assert coef[2] == coef[5] == 0.0            # z is flat
    assert coef[7] == f32(g.dt / g.eps0)
    assert coef[8:] == [f32(getattr(m, n)) for n in (
        "decayx", "decayy", "decayz", "drivex", "drivey", "drivez",
        "rmux", "rmuy", "rmuz")]
    assert faces[:6] == [FF._GHOST[bc] for bc in g.field_bc]
    assert faces[6] == faces[9] == 1 and faces[7] == faces[10] == 0
