"""Simulation.run in vpic_tpu's chunks (vpic_tpu/deck.py:1585-1625), on the
CPU: the gcd of status_interval and checkpt_interval, through
make_multi_step, single steps up to the chunk grid after a restore.

* With status_interval 6 and checkpt_interval 4 (chunk 2), run() writes
  the same energies file, byte for byte, and the same checkpoints (every
  array and the json) as a loop of single steps with the same diagnostics.
* From a restore at an unaligned step it lands on the same diagnostic
  steps (energies lines and checkpoint tags) as vpic_tpu.Simulation.run on
  the same deck.
* The quota ends the run at a chunk boundary (the aligning single steps
  count as one)."""

import os

import jax
import numpy as np
import pytest
import torch

import vpic_tpu as vj
import vpic_tpu_torch as vt
from vpic_tpu_torch import checkpoint as CK
from vpic_tpu_torch import dump as DU
from vpic_tpu_torch.models import harris

torch.set_num_threads(2)

H2 = dict(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0)
STATUS, CKPT = 6, 4


def _deck():
    sim = harris.build(harris.HarrisParams(**H2), device="cpu")
    sim.status_interval = STATUS
    return sim


def _singly(sim, state, n, energies, base):
    """The diagnostics of run(), one step at a time."""
    step = sim.make_step()
    DU.dump_energies(sim, state, energies, append=False)
    while state.step < n:
        state = step(state)
        k = state.step
        if k % STATUS == 0:
            DU.dump_energies(sim, state, energies)
        if k % CKPT == 0:
            CK.checkpt(state, base, sim=sim)
    return state


def _checkpoints(d, base):
    return sorted(int(f.split(".")[-2]) for f in os.listdir(d)
                  if f.startswith(base + ".") and f.endswith(".npz")
                  and f.split(".")[-2].isdigit())


def _energy_steps(path):
    with open(path) as fh:
        return [int(float(ln.split()[0])) for ln in fh
                if ln.strip() and not ln.startswith("%")]


def test_chunks_write_what_single_steps_write(tmp_path):
    n = 24
    runs = {}
    for how in ("chunks", "singly"):
        d = tmp_path / how
        d.mkdir()
        sim = _deck()
        state = sim.initialize()
        e, base = str(d / "energies"), str(d / "ck")
        if how == "chunks":
            out = sim.run(state, num_step=n, energies_file=e,
                          checkpt_base=base, checkpt_interval=CKPT,
                          verbose=False)
        else:
            out = _singly(sim, state, n, e, base)
        assert out.step == n
        runs[how] = d
    a, b = runs["chunks"], runs["singly"]
    assert (a / "energies").read_bytes() == (b / "energies").read_bytes()
    assert _energy_steps(a / "energies") == [0, 6, 12, 18, 24]
    tags = _checkpoints(a, "ck")
    assert tags == _checkpoints(b, "ck") == [4, 8, 12, 16, 20, 24]
    for t in tags:
        za, zb = np.load(a / f"ck.{t}.npz"), np.load(b / f"ck.{t}.npz")
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert np.array_equal(za[k], zb[k]), (t, k)
        assert (a / f"ck.{t}.json").read_bytes() == \
            (b / f"ck.{t}.json").read_bytes()


def _vacuum(pkg, **kw):
    """A field-only 8 x 8 deck (a standing wave) in either package: the
    diagnostics' landing does not depend on the physics, and vpic_tpu
    compiles its step quickly."""
    sim = pkg.Simulation(seed=0, **kw)
    sim.define_units(1.0, 1.0)
    g0 = pkg.partition_periodic_box(0, 0, 0, 1.0, 1.0, 1.0, 8, 8, 1)
    sim.define_timestep(0.5 * g0.courant_length())
    sim.define_periodic_grid((0, 0, 0), (1.0, 1.0, 1.0), (8, 8, 1))
    sim.define_material("vacuum", 1.0)
    sim.define_field_array(damp=0.0)
    sim.set_region_field(pkg.everywhere,
                         ey=lambda x, y, z: np.cos(2 * np.pi * x),
                         bz=lambda x, y, z: np.cos(2 * np.pi * x))
    sim.status_interval = STATUS
    return sim


def test_unaligned_restore_lands_where_vpic_tpu_lands(tmp_path):
    start, n = 5, 19
    steps = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        d.mkdir()
        e, base = str(d / "energies"), str(d / "ck")
        if pkg == "jax":
            sim = _vacuum(vj)
            state = sim.initialize()
            adv = jax.jit(sim.make_advance())
            for _ in range(start):
                state = adv(state)
        else:
            sim = _vacuum(vt, device="cpu")
            state = sim.make_multi_step(start)(sim.initialize())
        sim.run(state, num_step=n, energies_file=e, checkpt_base=base,
                checkpt_interval=CKPT, verbose=False)
        steps[pkg] = (_energy_steps(e), _checkpoints(d, "ck"))
    assert steps["torch"] == steps["jax"] == ([5, 6, 12, 18], [8, 12, 16])


@pytest.mark.parametrize("start,end", [(0, 2), (5, 6)])
def test_quota_ends_at_a_chunk_boundary(tmp_path, start, end):
    sim = _deck()
    state = sim.make_multi_step(start)(sim.initialize())
    base = str(tmp_path / "ck")
    out = sim.run(state, num_step=40, checkpt_base=base,
                  checkpt_interval=CKPT, quota_s=0.0, verbose=False)
    assert out.step == end
    back = CK.restore(base + ".quota", sim=_deck())
    assert back.step == end
