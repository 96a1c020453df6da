"""The deck runner (counterpart of ``python -m vpic_tpu``; the bin/vpic
analogue, deck/main.cc):

    python -m vpic_tpu_torch DECK [deck args...] [--device cuda|cpu]
        [--topology PX PY PZ] [--ranks N] [--restore FBASE.TAG [--remap]]
        [--modify FILE] [--num-step N] [--energies FILE]
        [--checkpt BASE[:INTERVAL]] [--quota SECONDS]

DECK is a ``.py`` file defining ``build(argv) -> Simulation`` (or
``build()``), or a built-in deck: harris, weibel, lpi, shapes,
reconnection, emission, twostream, weibel_gold, beam_plas, force_free,
sc08, asymm4sp, dipole, waveguide or cygnus.  The deck runs on
``--device``, the CUDA card by default.  The reference compiles decks into
the binary; here the deck is imported and its Simulation driven by
``Simulation.run()``.  ``main(argv)`` returns (sim, state).

A decomposed run is one process per rank.  Under torchrun (``torchrun
--nproc-per-node N -m vpic_tpu_torch DECK --topology PX PY PZ``) each
process joins the process group from the environment before the deck is
built; ``--ranks N`` spawns the N ranks itself (``parallel.mesh.launch``)
and returns rank 0's final (energies, step) instead.  ``--topology`` sets
the decomposition of a built-in deck (or of any deck whose ``build``
takes a parameter dataclass with a ``topology``).  With ``--remap`` the restore re-decomposes
a checkpoint written under another topology (``checkpoint.remap``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import inspect
import os
import sys

import torch

BUILT_INS = ("harris", "weibel", "lpi", "shapes", "reconnection",
             "emission", "twostream", "weibel_gold", "beam_plas",
             "force_free", "sc08", "asymm4sp", "dipole", "waveguide",
             "cygnus")


def load_deck(deck: str):
    """The deck's module: a ``.py`` file or a built-in's."""
    if deck.endswith(".py"):
        spec = importlib.util.spec_from_file_location("deck", deck)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    if deck not in BUILT_INS:
        raise ValueError(f"unknown deck {deck!r} (built-ins: "
                         f"{', '.join(BUILT_INS)})")
    return importlib.import_module(f"vpic_tpu_torch.models.{deck}")


def build_sim(mod, deck_args, device, topology=None):
    """Call the deck's build: with the deck's own arguments where its first
    parameter takes them (annotated ``list`` or named argv / args), with
    ``device`` where it takes one; the Simulation runs on ``device``
    either way.  ``topology`` replaces the one of the parameter dataclass
    the build takes first (its default's)."""
    params = inspect.signature(mod.build).parameters
    first = next(iter(params.values()), None)
    kw = {"device": device} if "device" in params else {}
    if first is not None and (first.annotation in (list, "list")
                              or first.name in ("argv", "args")):
        if topology is not None:
            raise ValueError("--topology: the deck takes its own arguments; "
                             "pass the topology there")
        sim = mod.build(deck_args, **kw)
    elif topology is not None:
        p = first.default if first is not None else None
        if not dataclasses.is_dataclass(p) or not hasattr(p, "topology"):
            raise ValueError("--topology: the deck's build takes no "
                             "parameters with a topology")
        sim = mod.build(dataclasses.replace(p, topology=tuple(topology)),
                        **kw)
    else:
        sim = mod.build(**kw)
    sim.device = torch.device(device)
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vpic_tpu_torch")
    ap.add_argument("deck", help="deck .py defining build() -> Simulation, "
                    f"or a built-in deck ({', '.join(BUILT_INS)})")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--restore", default=None,
                    help="checkpoint fbase.tag to restore from")
    ap.add_argument("--remap", action="store_true",
                    help="with --restore: re-decompose a checkpoint written "
                    "under another topology onto this deck's")
    ap.add_argument("--topology", type=int, nargs=3, default=None,
                    metavar=("PX", "PY", "PZ"),
                    help="the deck's decomposition, one rank per domain")
    ap.add_argument("--ranks", type=int, default=None,
                    help="spawn this many local ranks (parallel.mesh.launch)"
                    "; under torchrun leave it out")
    ap.add_argument("--modify", default=None,
                    help="ASCII overrides file (num_step, intervals)")
    ap.add_argument("--num-step", type=int, default=None)
    ap.add_argument("--energies", default=None, help="energies dump file")
    ap.add_argument("--checkpt", default=None,
                    help="BASE[:INTERVAL] interval checkpointing")
    ap.add_argument("--quota", type=float, default=None,
                    help="wall-clock quota in seconds (checkpoints + stops)")
    args, deck_args = ap.parse_known_args(argv)
    if args.remap and not args.restore:
        ap.error("--remap needs --restore")
    from .parallel import mesh as M
    if args.ranks is not None:
        rest = list(argv if argv is not None else sys.argv[1:])
        i = rest.index("--ranks")
        del rest[i:i + 2]
        # by its module's importable name: run as ``-m``, this module is
        # __main__, which a spawned rank cannot look a function up in
        entry = importlib.import_module("vpic_tpu_torch.__main__")
        return M.launch(entry._rank_main, args.ranks, args.device,
                        args=(rest,))[0]
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and M.current() is None:
        M.init(device=args.device)
    try:
        mod = load_deck(args.deck)
    except ValueError as e:
        ap.error(str(e))
    sim = build_sim(mod, deck_args, args.device, args.topology)

    from . import checkpoint as CK
    if args.modify:
        CK.modify(sim, args.modify)
    state = None
    if args.restore:
        state = (CK.remap(args.restore, sim) if args.remap
                 else CK.restore(args.restore, sim=sim))
    base, interval = None, 0
    if args.checkpt:
        parts = args.checkpt.split(":")
        base = parts[0]
        interval = int(parts[1]) if len(parts) > 1 else 0
    state = sim.run(state, num_step=args.num_step,
                    energies_file=args.energies, checkpt_base=base,
                    checkpt_interval=interval, quota_s=args.quota)
    return sim, state


def _rank_main(argv):
    """One spawned rank of ``--ranks``: (energies, step) for the parent
    (a Simulation does not cross processes)."""
    sim, state = main(argv)
    return sim.energies(state).double().cpu().numpy(), state.step


if __name__ == "__main__":
    main()
    from .parallel import mesh as _mesh
    _mesh.finalize()    # a torchrun rank leaves its process group
