"""A plain reference of the collisional reconnection deck
(``vpic_tpu_torch.models.reconnection``: the Harris sheet with three
Takizuka-Abe ops, ion-ion, electron-electron and electron-ion, every
``tau_coll_interval`` steps), composed from the reference's parts: the
harris reference's geometry, field scales and initial state, and a step
that runs the ops the program fired (``reference/collision.py``, fed the
program's draws) and then ``pic.step``.

``register()`` makes it the configuration reference ``NAME`` of the
harness (``core.reference``)."""

import dataclasses
import sys

from benchmark.reference import collision, harris, pic

NAME = "collisional_reconnection"
MODULE = f"benchmark.reference.{NAME}"


def geom(p: dict) -> collision.Geom:
    base = dataclasses.asdict(harris.geom(p))
    return collision.Geom(**base, log_lambda=p["log_lambda"],
                          n0=p["coll_n0"])


field_scales = harris.field_scales
initial_state = harris.initial_state


def step(fields, species, g: collision.Geom, k: int, draws):
    if draws is not None:
        species = collision.collide(species, draws, g)
    return pic.step(fields, species, g, k)


def register():
    """This module as ``benchmark.reference.<NAME>``."""
    sys.modules[MODULE] = sys.modules[__name__]


def config(base: dict, interval: int, log_lambda: float = 10.0,
           n0: float = 1.0) -> dict:
    """A harris configuration turned into the collisional deck's: the
    program's reconnection builder, this reference, and the ops'
    cadence, Coulomb logarithm and density."""
    params = dict(base["params"], tau_coll_interval=interval,
                  log_lambda=log_lambda, coll_n0=n0)
    return dict(base, name="reconnection", params=params, reference=NAME,
                program={"module": "vpic_tpu_torch.models.reconnection",
                         "params": "ReconnectionParams"})
