"""The comparison that decides ``correct``: the program's states against
the plain reference's (``benchmark/reference``).

What is compared, once the window has closed:

* the start: the state the program's set-up made (build and initialize)
  against the one the reference makes from the seed alone, lane by lane
  in injection order;
* a sample of steps of one repeat of the window's run, driven through the
  same step object the window replayed: for step ``k`` the reference
  steps the program's own state before it, and the program's state after
  it is compared with the reference's result.  The lanes are compared as
  a set (the relayouts reorder them), the fields array by array.

Each compared number is the worst over every check of the run:

``lane_pos_err``   the largest distance, in cells, between a lane and its
                   partner on the other side;
``lane_mom_err``   the largest momentum difference of partners, over the
                   species' largest momentum component;
``lanes_unmatched`` the difference of the live lane counts;
``e_err``, ``b_err``, ``jf_err``, ``rho_err``: the largest difference of
                   E, cB, the edge currents and the node charge (on
                   cleaning steps and at the start), over the largest
                   magnitude of that field in the reference or, where
                   that is smaller, the deck's own amplitude of it.

Partners: both lane sets are sorted by ``ux``; a lane's partner is the
lane among the ``WINDOW`` nearest in that order on the other side that is
closest in position and momentum.  Rounding moves a lane by a few places
in that order at most, so a sound program finds every partner; the match
is made both ways, so a lane lost or doubled leaves one side without one.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .reference import pic

WINDOW = 16
NAMES = ("lane_pos_err", "lane_mom_err", "lanes_unmatched", "e_err",
         "b_err", "jf_err", "rho_err")
_GROUPS = {"e_err": ("ex", "ey", "ez"), "b_err": ("cbx", "cby", "cbz"),
           "jf_err": ("jfx", "jfy", "jfz"), "rho_err": ("rhof",)}


def empty() -> Dict[str, float]:
    return dict.fromkeys(NAMES, 0.0)


def _num(v: float) -> float:
    """A reading, with NaN read as the worst value."""
    return float("inf") if v != v else v


def merge(into: Dict[str, float], got: Dict[str, float]):
    for k, v in got.items():
        into[k] = max(into[k], _num(v))


def field_errs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               groups, floors: Dict[str, float]) -> Dict[str, float]:
    """Each group's largest difference over the larger of the group's
    largest magnitude in the reference and the deck's own amplitude of
    that field (``floors``): a field that is zero but for rounding, as
    the net charge of a load in pairs, is not judged by its rounding."""
    out = {}
    for key in groups:
        names = _GROUPS[key]
        scale = max([_num(float(ref[n].abs().max())) for n in names]
                    + [floors[key]])
        diff = max(_num(float((prog[n].float() - ref[n].float()).abs().max()))
                   for n in names)
        out[key] = diff / scale
    return out


def _coords(sp, g: pic.Geom):
    """Global positions in cells (float64) and momenta of a lane set."""
    x, y, z = pic.decode(sp["i"].long(), g)
    pos = [(c - 1).double() + (sp[o].double() + 1.0) * 0.5
           for c, o in zip((x, y, z), ("dx", "dy", "dz"))]
    mom = [sp[k].double() for k in ("ux", "uy", "uz")]
    return pos, mom


def _match(a, b, g: pic.Geom, uscale: float):
    """Per lane of a, against its partner in b (both sorted by ux, b not
    empty): (position error plus momentum error, position error, momentum
    error)."""
    pa, ua = a
    pb, ub = b
    na, nb = pa[0].numel(), pb[0].numel()
    wrap = [g.particle_bc[k] == pic.P_PERIODIC for k in range(3)]
    base = torch.arange(na, device=pa[0].device)
    best = torch.full((na,), float("inf"), dtype=torch.float64,
                      device=pa[0].device)
    best_pos = torch.zeros_like(best)
    best_mom = torch.zeros_like(best)
    for s in range(-WINDOW, WINDOW + 1):
        j = torch.clamp(base + s, 0, nb - 1)
        dpos = torch.zeros_like(best)
        for k in range(3):
            d = (pa[k] - pb[k][j]).abs()
            if wrap[k]:
                d = torch.minimum(d, g.n[k] - d)
            dpos = torch.maximum(dpos, d)
        dmom = torch.zeros_like(best)
        for k in range(3):
            dmom = torch.maximum(dmom, (ua[k] - ub[k][j]).abs())
        dmom = dmom / uscale
        d = dpos + dmom
        take = d < best
        best = torch.where(take, d, best)
        best_pos = torch.where(take, dpos, best_pos)
        best_mom = torch.where(take, dmom, best_mom)
    return best, best_pos, best_mom


def _one_way(a, b, g: pic.Geom, uscale: float):
    """(position error, momentum error) of a's lanes against their
    partners in b, both sorted by ux."""
    na, nb = a[0][0].numel(), b[0][0].numel()
    if na == 0:
        return 0.0, 0.0
    if nb == 0:
        return float("inf"), float("inf")
    best, best_pos, best_mom = _match(a, b, g, uscale)
    # a lane with no partner at any finite distance (NaN included)
    lost = ~torch.isfinite(best)
    return (_num(float(torch.where(lost, float("inf"), best_pos).max())),
            _num(float(torch.where(lost, float("inf"), best_mom).max())))


def _sorted(sp, g):
    order = torch.argsort(sp["ux"].float())
    pos, mom = _coords({k: sp[k][order] for k in pic.LANE_NAMES}, g)
    return pos, mom


def lane_errs(prog: List[dict], ref: List[dict], g: pic.Geom,
              ordered: bool = False) -> Dict[str, float]:
    """Lane errors of each species.  ``ordered``: the two sides hold the
    same lanes in the same order (the start), so lane k is k's partner."""
    out = {"lane_pos_err": 0.0, "lane_mom_err": 0.0, "lanes_unmatched": 0.0}
    for a, b in zip(prog, ref):
        uscale = _uscale(b)
        out["lanes_unmatched"] += abs(a["ux"].numel() - b["ux"].numel())
        if ordered and a["ux"].numel() == b["ux"].numel():
            (pa, ua), (pb, ub) = _coords(a, g), _coords(b, g)
            pe = max(_num(float((x - y).abs().max())) for x, y in zip(pa, pb))
            me = max(_num(float((x - y).abs().max())) for x, y in zip(ua, ub))
            errs = [(pe, me / uscale)]
        else:
            sa, sb = _sorted(a, g), _sorted(b, g)
            errs = [_one_way(sa, sb, g, uscale), _one_way(sb, sa, g, uscale)]
        for pe, me in errs:
            out["lane_pos_err"] = max(out["lane_pos_err"], _num(pe))
            out["lane_mom_err"] = max(out["lane_mom_err"], _num(me))
    return out


def _uscale(sp) -> float:
    u = max(float(sp[k].abs().max()) for k in ("ux", "uy", "uz"))
    return u if u > 0 else 1.0


def partner_errs(prog: List[dict], ref: List[dict],
                 g: pic.Geom) -> List[torch.Tensor]:
    """Per species, each reference lane's distance to its partner among
    the program's lanes (position error plus momentum error, as
    ``lane_errs`` finds partners), in the reference's lane order."""
    out = []
    for a, b in zip(prog, ref):
        order = torch.argsort(b["ux"].float())
        if a["ux"].numel() == 0:
            out.append(torch.full(order.shape, float("inf"),
                                  dtype=torch.float64, device=order.device))
            continue
        sb = _coords({k: b[k][order] for k in pic.LANE_NAMES}, g)
        best = _match(sb, _sorted(a, g), g, _uscale(b))[0]
        out.append(torch.empty_like(best).index_copy_(0, order, best))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) with every compared number."""
    rows = [(k, numbers[k], limits[k]) for k in NAMES]
    ok = all(v <= lim for _, v, lim in rows)
    return ok, rows
