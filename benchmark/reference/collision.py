"""The plain reference of the Takizuka-Abe binary collision op, in plain
PyTorch.

Takizuka & Abe, J. Comput. Phys. 25, 205 (1977): cumulative small-angle
Coulomb collisions between pairs of particles of one cell, as VPIC's
``sample/reconnection/open-collisional`` runs them at deck level, within
the binary-collision framework of VPIC's ``src/collision`` (``binary.c``,
``binary_pipeline.c``, ``hard_sphere.c``).  It imports nothing of the
program: the benchmark holds the program against it, so it must not move
when the program changes.

A species is the reference's plain dict (``pic.py``: the live lanes'
``dx dy dz i ux uy uz w`` with ``q`` and ``m``).  One op's draws are plain
data, made by the program's generator and handed over by the harness:

``pair``      (i, j), the indices of the two species; i == j within one;
``interval``  the op's cadence in steps: one firing stands for
              ``interval`` steps of collisions;
``q``, ``m``  the charges and masses of species i and j;
``rounds``    one dict a pairing round: ``shuf_i`` (and ``shuf_j``
              between species), a 31-bit key a live lane in the order the
              lanes have as the round starts, and the per-pair variates
              ``pr`` (uniform), ``phi`` (uniform), ``theta`` (standard
              normal) and ``bal`` (uniform), by position in the shuffled
              live lanes: pair m within a species, i-lane p between.

The op, on a species pair:

1. the per-cell shuffle: each species' lanes in a stable sort by voxel,
   ties by key;
2. the pairs: within a species, shuffled lanes 2m and 2m + 1 when they
   lie in one voxel; between species, the r-th i-lane of a voxel with the
   (r mod n_j)-th j-lane of it, n_j being the voxel's j-lanes;
3. the probability of a candidate pair (binary.c:106-117):
   w_max K (dt interval / dV) n_pairs / n_cand, with n_pairs = n (n + 1)/2
   and n_cand = max(n / 2, 1) over the voxel's n lanes within a species,
   and n_pairs / n_cand = n_j between species; the pair collides where
   ``pr`` falls below it.  T&A's rate saturates it (K infinite): every
   candidate collides, and the rate lies in the angle;
4. the angle: tan(theta / 2) = delta, delta = sigma ``theta``,
   sigma^2 = (q_i q_j)^2 n0 log_lambda dt interval
   / (8 pi eps0^2 mu^2 v_r^3), with mu = m_i m_j / (m_i + m_j) and
   v_r = |u_i - u_j| c;
5. the scattering geometry (hard_sphere.c:126-236): for the relative
   momentum u_r, a unit T1 perpendicular to it, T2 = u_r x T1 / |u_r|,
   the azimuth phi = 2 pi ``phi``, and the change
   d = (cos theta - 1) u_r + sin theta |u_r| (cos phi T1 + sin phi T2);
6. detailed balance (binary_pipeline.c:143-152): the lighter computational
   particle always takes its share, u_i += (mu / m_i) d and
   u_j -= (mu / m_j) d, the heavier only where ``bal`` w_max < w_min.

Where this follows the program's pairing rather than VPIC's deck-level
code: the lanes have to pair as the program paired them, draw for draw,
for a step to be comparable lane by lane (the same variates on other
pairs give another plasma, as valid, that no lane-by-lane check can
judge).  So it takes from the program's documented design:

* one shuffle over all of a species' lanes, keyed by the drawn keys, in
  place of VPIC's per-cell random pair picks;
* pairs within a species at even and odd places of the whole shuffled
  order, so a voxel whose lanes start at an odd place leaves its first
  lane unpaired, and the last of an odd count too;
* the (r mod n_j) rule between species, several i-lanes sharing a j-lane
  whose changes then add;
* one standard normal a pair for delta, clamped to [-1e3, 1e3], and no
  scattering where v_r <= 1e-12;
* T1 from u_r with its smallest component set to zero (ties to the
  earlier axis) and the other two swapped, one negated: (0, -u_z, u_y),
  (-u_z, 0, u_x) or (-u_y, u_x, 0);
* each species left in its shuffled order, which the next op's keys
  follow; ``collide`` puts the lanes back in their order at the end.

Two-valued pairs.  T1's branch, which component of u_r is the smallest,
is a discontinuity of the geometry: where two components are near equal in
magnitude, rounding decides it, and the two branches scatter the pair in
two directions on one cone.  An op whose inputs are the outputs of an
earlier op of the step (the electron-ion op after the ion-ion and
electron-electron ones) gets inputs that differ from the program's by
rounding, so at such pairs the reference's branch and the program's can
differ, both sound.  ``collide`` marks the lanes of every pair whose two
smallest components lie within TWO_VALUED of each other (``two_valued``),
and takes the other branch for the pairs an op's ``flip`` names; the
harness picks, pair by pair, the branch that the program's lanes match.

Every function works in the dtype of the species' momenta (float32 for the
reference, bfloat16 for the control); the keys stay integers.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import torch

from . import pic

# no scattering for pairs slower than this (v_r, in units of c)
V_MIN = 1e-12
DELTA_MAX = 1e3
# a pair is two-valued where the two smallest components of u_r in
# magnitude lie within this share of |u_i| + |u_j| (summed over the
# components) of each other: some hundred times float32's rounding
TWO_VALUED = 1e-5
# the key under which ``collide`` carries each lane's place in its input
TAG = "_lane"


@dataclass(frozen=True)
class Geom(pic.Geom):
    """A domain (pic.Geom) with the deck's Coulomb logarithm and the
    density of the T&A variance."""

    log_lambda: float = 10.0
    n0: float = 1.0


def _take(sp: dict, idx: torch.Tensor) -> dict:
    """The species' lanes in the order ``idx``: every per-lane tensor
    gathered, the rest kept."""
    n = sp["w"].numel()
    return {k: v[idx] if isinstance(v, torch.Tensor) and v.dim() == 1
            and v.numel() == n else v for k, v in sp.items()}


def shuffle(sp: dict, keys: torch.Tensor) -> dict:
    """The per-cell shuffle: lanes sorted by voxel, ties by key, ties of
    both by their order (two stable sorts, the key's first)."""
    by_key = torch.sort(keys.long(), stable=True).indices
    by_vox = torch.sort(sp["i"].long()[by_key], stable=True).indices
    return _take(sp, by_key[by_vox])


def _cells(vox: torch.Tensor, nv: int):
    """(first lane, lanes) of every voxel over lanes sorted by voxel."""
    count = torch.bincount(vox, minlength=nv)
    return torch.cumsum(count, 0) - count, count


def _axis(ur, scale, flip):
    """(the axis T1 zeroes, two-valued): the axis of u_r's smallest
    component in magnitude, ties to the earlier axis, or where ``flip``
    the second smallest; two-valued where the two smallest lie within
    TWO_VALUED ``scale`` of each other."""
    mag, axes = torch.sort(torch.stack([c.abs() for c in ur]), dim=0,
                           stable=True)
    two = mag[1] - mag[0] <= TWO_VALUED * scale
    return torch.where(flip, axes[1], axes[0]), two


def _perpendicular(ur, axis):
    """T1: u_r with the component ``axis`` zeroed and the other two
    swapped, one negated (see the docstring), made a unit vector."""
    x, y, z = ur
    zero = torch.zeros_like(x)
    t = (torch.where(axis == 0, zero, torch.where(axis == 1, -z, -y)),
         torch.where(axis == 1, zero, torch.where(axis == 0, -z, x)),
         torch.where(axis == 2, zero, torch.where(axis == 0, y, x)))
    norm = torch.sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2])
    norm = torch.clamp(norm, min=1e-15)
    return tuple(c / norm for c in t)


def _change(ur, cos_t, sin_t, phi, axis):
    """d = (cos theta - 1) u_r + sin theta |u_r| (cos phi T1 + sin phi T2)."""
    mag = torch.sqrt(ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2])
    t1 = _perpendicular(ur, axis)
    inv = 1.0 / torch.clamp(mag, min=1e-15)
    t2 = ((ur[1] * t1[2] - ur[2] * t1[1]) * inv,
          (ur[2] * t1[0] - ur[0] * t1[2]) * inv,
          (ur[0] * t1[1] - ur[1] * t1[0]) * inv)
    c, s = torch.cos(phi), torch.sin(phi)
    return [(cos_t - 1.0) * ur[a] + sin_t * mag * (c * t1[a] + s * t2[a])
            for a in range(3)]


def _angle(ur, normal, op: dict, g: Geom):
    """(cos theta, sin theta, scatters) of T&A's small-angle scattering;
    ``scatters`` is false for pairs slower than V_MIN."""
    (qi, qj), (mi, mj) = op["q"], op["m"]
    mu = mi * mj / (mi + mj)
    coef = (qi * qj) ** 2 * g.n0 * g.log_lambda * g.dt * op["interval"] / (
        8.0 * math.pi * g.eps0 ** 2 * mu ** 2)
    vr = torch.sqrt(ur[0] * ur[0] + ur[1] * ur[1] + ur[2] * ur[2]) * g.cvac
    v = torch.clamp(vr, min=V_MIN)
    delta = torch.sqrt(coef / (v * v * v)) * normal
    scatters = vr > V_MIN
    delta = torch.where(scatters, torch.clamp(delta, -DELTA_MAX, DELTA_MAX),
                        torch.zeros_like(delta))
    d2 = delta * delta
    return (1.0 - d2) / (1.0 + d2), 2.0 * delta / (1.0 + d2), scatters


def _round(si: dict, sj: dict, d: dict, op: dict, g: Geom, r: int):
    """Round ``r`` of an op on shuffled species: (si, sj) with new momenta
    (the same dict twice within one species), and the codes
    ``r << 32 | pair`` of its two-valued pairs with their i- and j-lanes'
    places."""
    intra = op["pair"][0] == op["pair"][1]
    dtype = si["ux"].dtype
    var = {k: d[k].to(dtype) for k in ("pr", "phi", "theta", "bal")}
    vi = si["i"].long()
    start_i, n_i = _cells(vi, g.nv)
    if intra:
        half = vi.numel() // 2
        a = torch.arange(half, device=vi.device) * 2
        b = a + 1
        same = vi[a] == vi[b]
        n = n_i[vi[a]].to(dtype)
        ratio = 0.5 * n * (n + 1.0) / torch.clamp(0.5 * n, min=1.0)
    else:
        vj = sj["i"].long()
        start_j, n_j = _cells(vj, g.nv)
        a = torch.arange(vi.numel(), device=vi.device)
        rank = a - start_i[vi]
        same = n_j[vi] > 0
        b = start_j[vi] + rank % torch.clamp(n_j[vi], min=1)
        b = torch.where(same, b, 0)
        ratio = n_j[vi].to(dtype)
    ui = [si[k][a] for k in ("ux", "uy", "uz")]
    uj = [sj[k][b] for k in ("ux", "uy", "uz")]
    wi, wj = si["w"][a], sj["w"][b]
    w_max, w_min = torch.maximum(wi, wj), torch.minimum(wi, wj)
    # T&A's rate saturates the probability: every candidate collides
    prob = w_max * ratio * (g.dt * op["interval"] * g.r8V * 8.0) * math.inf
    hit = same & (var["pr"] < prob / len(op["rounds"]))
    ur = [x - y for x, y in zip(ui, uj)]
    cos_t, sin_t, scatters = _angle(ur, var["theta"], op, g)
    flip = torch.zeros_like(hit)
    codes = op.get("flip")
    if codes is not None:
        mine = codes[codes >> 32 == r] & 0xFFFFFFFF
        flip[mine.to(a.device)] = True
    scale = sum(x.abs() + y.abs() for x, y in zip(ui, uj))
    axis, two = _axis(ur, scale, flip)
    change = _change(ur, cos_t, sin_t, 2.0 * math.pi * var["phi"], axis)
    heavy = var["bal"] * w_max < w_min
    (mi, mj) = op["m"]
    mu = mi * mj / (mi + mj)
    fi = torch.where(hit & ((wi <= wj) | heavy), mu / mi, 0.0).to(dtype)
    fj = torch.where(hit & ((wj <= wi) | heavy), mu / mj, 0.0).to(dtype)
    si = dict(si)
    sj = si if intra else dict(sj)
    for k, dk in zip(("ux", "uy", "uz"), change):
        si[k] = si[k].clone()
        si[k][a] += fi * dk
        if intra:
            si[k][b] -= fj * dk
        else:
            sj[k] = sj[k].index_add(0, b, -fj * dk)
    pairs = torch.nonzero(two & hit & scatters).flatten()
    return si, sj, ((r << 32) | pairs, a[pairs], b[pairs])


def takizuka_abe(si: dict, sj: dict, op: dict, g: Geom):
    """One op on species i and j (the same dict twice within a species):
    its rounds, each a shuffle and a pairing.  Returns (si, sj) after the
    op, each in its last shuffled order, and per round the codes of its
    two-valued pairs with their i- and j-lanes' places in that round's
    order.  ``op["flip"]``, where given, holds the codes of pairs that
    take T1's other branch."""
    intra = op["pair"][0] == op["pair"][1]
    two = []
    for r, d in enumerate(op["rounds"]):
        si = shuffle(si, d["shuf_i"])
        sj = si if intra else shuffle(sj, d["shuf_j"])
        si, sj, got = _round(si, sj, d, op, g, r)
        codes, a, b = got
        two.append((codes, si[TAG][a] if TAG in si else a,
                    sj[TAG][b] if TAG in sj else b))
    return si, sj, two


def collide(species: List[dict], draws: List[dict], g: Geom) -> List[dict]:
    """Every op of ``draws`` in order on the species list; the lanes come
    back in the order they came in, each with ``two_valued``: the id
    ``op << 36 | code`` of the last two-valued pair it was in, else -1."""
    out = [dict(sp, **{TAG: torch.arange(sp["w"].numel(),
                                         device=sp["w"].device)})
           for sp in species]
    marks = [torch.full_like(sp[TAG], -1) for sp in out]
    for n, op in enumerate(draws):
        i, j = op["pair"]
        out[i], out[j], two = takizuka_abe(out[i], out[j], op, g)
        for codes, lanes_i, lanes_j in two:
            marks[i][lanes_i] = (n << 36) | codes
            marks[j][lanes_j] = (n << 36) | codes
    back = []
    for sp, mark in zip(out, marks):
        sp = _take(sp, torch.argsort(sp.pop(TAG)))
        back.append(dict(sp, two_valued=mark))
    return back
