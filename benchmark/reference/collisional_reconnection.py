"""The plain reference of the collisional reconnection deck: VPIC's
``sample/reconnection/open-collisional``, the Harris sheet of
``sample/harris`` (Daughton, Phys. Plasmas 9, 3668 (2002)) with three
deck-level Takizuka-Abe operators (T&A, J. Comput. Phys. 25, 205 (1977)),
ion-ion, electron-electron and electron-ion, every ``tau_coll_interval``
steps, in plain PyTorch and float32.

It is composed from the reference's parts: the harris reference's
geometry, field scales and initial state (``harris.py``), and a step that
runs the T&A ops the program fired, fed the program's own draws
(``collision.py``), then one PIC step (``pic.py``).  It imports nothing of
the program.  The operators run before the push, as VPIC's advance.cc
runs a deck's collisions; their density scale of the T&A variance is
``coll_n0`` and their Coulomb logarithm ``log_lambda`` (the configuration's
``params``).

TF32 stays off: a float32 matrix product on the card may otherwise run in
a lower precision (the step makes none today)."""

from __future__ import annotations

import dataclasses

import torch

from . import collision, harris, pic

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def geom(p: dict) -> collision.Geom:
    """The harris geometry with the ops' Coulomb logarithm and density."""
    base = dataclasses.asdict(harris.geom(p))
    return collision.Geom(**base, log_lambda=p["log_lambda"],
                          n0=p["coll_n0"])


field_scales = harris.field_scales
initial_state = harris.initial_state


def step(fields, species, g: collision.Geom, k: int, draws):
    """Step ``k``: the ops that fired with ``draws`` (None where none did),
    then ``pic.step``."""
    if draws is not None:
        species = collision.collide(species, draws, g)
    return pic.step(fields, species, g, k)
