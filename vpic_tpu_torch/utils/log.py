"""Rank-tagged logging: the util_base.h MESSAGE/WARNING/ERROR macros
(util_base.h:255-270) and the deck-level ``sim_log`` (rank-0 only,
deck/wrapper.h:57-65).

The reference prints "rank file(line): msg" through log_printf; here the
same shape goes to stderr, with the caller's file:line resolved from the
stack.  ERROR raises (the reference aborts)."""

from __future__ import annotations

import inspect
import os
import sys


def _site(depth: int = 2) -> str:
    fr = inspect.stack()[depth]
    return f"{os.path.basename(fr.filename)}({fr.lineno})"


def _rank() -> int:
    return int(os.environ.get("VPIC_TPU_RANK", "0"))


def message(*args):
    print(f"{_rank()} {_site()}: " + " ".join(str(a) for a in args),
          file=sys.stderr, flush=True)


def warning(*args):
    print(f"{_rank()} {_site()}: WARNING: "
          + " ".join(str(a) for a in args), file=sys.stderr, flush=True)


def error(*args):
    """ERROR macro analogue: log and raise (the reference mp_aborts)."""
    msg = f"{_rank()} {_site()}: ERROR: " + " ".join(str(a) for a in args)
    print(msg, file=sys.stderr, flush=True)
    raise RuntimeError(msg)


def sim_log(*args, rank: int = 0):
    """sim_log (deck/wrapper.h:57-65): rank-0-only progress line."""
    if _rank() == rank:
        print("SIM:", *args, file=sys.stderr, flush=True)
