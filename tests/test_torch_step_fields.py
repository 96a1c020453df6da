"""The step's field advance (``Simulation.field_advance``): the fused
field_beb kernel on every deck it covers, the plain trio, with the reasons,
on the rest.  On the CPU the fused trio runs its plain version
(ops/field_fuse.beb_ref: the same three calls in the same order), so the
step stays bit for bit what the three plain calls give.  The kernel's
coefficient and face arguments are packed in pure Python, so they are
checked here; the kernel against the plain trio is on the card
(tests/test_torch_cuda_protos.py).  Its parity with vpic_tpu's Pallas
prototype is tests/test_torch_field_fuse.py."""

import numpy as np
import pytest
import torch

import vpic_tpu_torch.grid as GT
import vpic_tpu_torch.ops.field_fuse as FF
import vpic_tpu_torch.ops.fields as F
from vpic_tpu_torch.models import (emission, harris, lpi, reconnection,
                                   shapes, weibel)

from torch_parity import field_pair

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


def _args_case(name):
    """(grid, material, damp): a DECKS deck's, or field_pair's walled or
    periodic grid with damping 0.02."""
    if name in DECKS:
        sim = DECKS[name]()
        return sim.grid, sim._material_coeffs(), sim.damp
    _, (g, _, m) = field_pair(name)
    return g, m, 0.02


# csrc/field_beb.cu's ghost rule per face bc: 0 wrap, 1 mirror, -1 negated
RULE = {GT.PERIODIC: 0, GT.PEC: 1, GT.SYMMETRIC: -1, GT.PMC: -1}


@pytest.mark.parametrize("case", ["harris2d", "harris3d", "pec3d",
                                  "walls3d", "periodic3d"])
def test_kernel_args_pack_the_plain_coefficients(case):
    """The kernel's 17 coefficients and 12 face ints: the plain ops'
    float32 values (exactly 0 along a flat axis), the ghost rule of every
    face (wrap, mirror on pec, negated mirror on symmetric and pmc) and
    the pec flags."""
    g, m, damp = _args_case(case)
    coef, faces = FF.kernel_args(g, m, damp)
    coef, faces = list(coef), list(faces)
    assert len(coef) == 17 and len(faces) == 12
    f32 = lambda x: float(np.float32(x))
    rd = (g.rdx, g.rdy, g.rdz)
    flat = (g.gnx == 1, g.gny == 1, g.gnz == 1)
    assert any(flat) == (case == "harris2d")
    for a in range(3):
        if flat[a]:
            assert coef[a] == coef[3 + a] == 0.0
        else:
            assert coef[a] == f32(0.5 * g.cvac * g.dt * rd[a])
            assert coef[3 + a] == f32((1 + damp) * g.cvac * g.dt * rd[a])
    assert coef[6] == f32(damp)
    assert coef[7] == f32(g.dt / g.eps0)
    assert coef[8:] == [f32(getattr(m, n)) for n in (
        "decayx", "decayy", "decayz", "drivex", "drivey", "drivez",
        "rmux", "rmuy", "rmuz")]
    assert faces[:6] == [RULE[bc] for bc in g.field_bc]
    assert faces[6:] == [int(bc == GT.PEC) for bc in g.field_bc]
