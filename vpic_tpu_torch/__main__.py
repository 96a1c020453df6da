"""The deck runner (counterpart of ``python -m vpic_tpu``; the bin/vpic
analogue, deck/main.cc):

    python -m vpic_tpu_torch DECK [deck args...] [--device cuda|cpu]
        [--restore FBASE.TAG] [--modify FILE] [--num-step N]
        [--energies FILE] [--checkpt BASE[:INTERVAL]] [--quota SECONDS]

DECK is a ``.py`` file defining ``build(argv) -> Simulation`` (or
``build()``), or a built-in deck: harris, weibel, lpi, shapes,
reconnection, emission, twostream, weibel_gold, beam_plas, force_free,
sc08, asymm4sp, dipole, waveguide or cygnus.  The deck runs on
``--device``, the CUDA card by default.  The reference compiles decks into
the binary; here the deck is imported and its Simulation driven by
``Simulation.run()``.  ``main(argv)`` returns (sim, state).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect

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


def build_sim(mod, deck_args, device):
    """Call the deck's build: with the deck's own arguments where its first
    parameter takes them (annotated ``list`` or named argv / args), with
    ``device`` where it takes one; the Simulation runs on ``device``
    either way."""
    params = inspect.signature(mod.build).parameters
    first = next(iter(params.values()), None)
    kw = {"device": device} if "device" in params else {}
    if first is not None and (first.annotation in (list, "list")
                              or first.name in ("argv", "args")):
        sim = mod.build(deck_args, **kw)
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
                    help="with --restore: re-decompose the checkpoint "
                    "(not ported: it waits for decomposition)")
    ap.add_argument("--modify", default=None,
                    help="ASCII overrides file (num_step, intervals)")
    ap.add_argument("--num-step", type=int, default=None)
    ap.add_argument("--energies", default=None, help="energies dump file")
    ap.add_argument("--checkpt", default=None,
                    help="BASE[:INTERVAL] interval checkpointing")
    ap.add_argument("--quota", type=float, default=None,
                    help="wall-clock quota in seconds (checkpoints + stops)")
    args, deck_args = ap.parse_known_args(argv)
    if args.remap:
        raise NotImplementedError(
            "--remap is not ported: it waits for decomposition")
    try:
        mod = load_deck(args.deck)
    except ValueError as e:
        ap.error(str(e))
    sim = build_sim(mod, deck_args, args.device)

    from . import checkpoint as CK
    if args.modify:
        CK.modify(sim, args.modify)
    state = CK.restore(args.restore, sim=sim) if args.restore else None
    base, interval = None, 0
    if args.checkpt:
        parts = args.checkpt.split(":")
        base = parts[0]
        interval = int(parts[1]) if len(parts) > 1 else 0
    state = sim.run(state, num_step=args.num_step,
                    energies_file=args.energies, checkpt_base=base,
                    checkpt_interval=interval, quota_s=args.quota)
    return sim, state


if __name__ == "__main__":
    main()
