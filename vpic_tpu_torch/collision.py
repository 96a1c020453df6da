"""Monte-Carlo collision operators (counterpart of ``vpic_tpu/collision.py``:
the binary and unary frameworks of src/collision/, the hard-sphere and
large-angle Coulomb models, Langevin, and the Takizuka-Abe operator of
sample/reconnection/open-collisional as a first-class model).

Pairing is the JAX package's: both species are sorted by (voxel, random)
-- a per-cell shuffle; intraspecies pairs are the globally adjacent slots
(2m, 2m+1) that share a voxel; interspecies, the r-th shuffled i-lane of a
cell pairs with the (r mod nl)-th j-lane and the j-side updates are
scatter-adds.  The rate -> probability normalization is binary.c:106-117,
the detailed-balance rule binary_pipeline.c:143-152, and the scattering
geometry hard_sphere.c:126-236 (see the JAX module's docstring).

Draw, then apply: every op is two parts.  ``draw(generator, species)``
makes the raw standard variates with exactly the shapes the JAX op draws
(31-bit ints for the shuffle, uniforms in [0, 1), standard normals) from
an explicit ``torch.Generator``; ``apply(species, g, draws)`` does all the
rest, including the scalings the JAX package folds into its draw calls
(phi = 2 pi u where it draws ``uniform(0, 2 pi)``).  The op the step calls
runs ``apply(draw(generator))``.  Fed the variates that ``jax.random``
makes from the JAX op's keys, ``apply`` reproduces that op's result: the
same permutation, and the momenta to float32 rounding.  Where the JAX op
hands a key to a user callable, the port hands it the raw variate of the
kind the model declares: ``BinaryModel.variate`` for ``sample_angle``, the
collide callback's ``variates`` for a unary op.

On CUDA tensors a Takizuka-Abe op (``make_takizuka_abe_op``, one pairing
round) runs the hand-written kernels of ``ops/ta_collide``: an
order pass a shuffled species and one pair kernel, bit for bit the plain
op's permutation; every other model, and every op on the CPU, runs the
plain op below, the kernels' reference.  ``op.route`` says which ran last.

Nothing here reads the device on the host: the ops add no synchronization
to a step.  All arithmetic is float32 in the JAX package's operation
order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .grid import Grid
from .ops import ta_collide as TA
from .ops.push import gather_sp_rows
from .state import SpeciesParams, SpeciesState

# voxel key of dead lanes in the shuffle (they sort last)
_DEAD_KEY = 2 ** 30


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------

def variate(generator, kind: str, shape, device) -> torch.Tensor:
    """Standard variates of ``kind``: "uniform" in [0, 1) or "normal", as
    float32 of ``shape``, from ``generator``."""
    if kind == "uniform":
        return torch.rand(shape, generator=generator, device=device)
    if kind == "normal":
        return torch.randn(shape, generator=generator, device=device)
    raise ValueError(f"unknown variate kind {kind!r}")


def shuffle_bits(generator, n: int, device) -> torch.Tensor:
    """n random 31-bit ints (int32), the JAX package's ``bits >> 1``."""
    return torch.randint(0, 2 ** 31, (n,), generator=generator,
                         device=device, dtype=torch.int32)


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """The float32 quotient c / t in one rounding (a Python number over a
    tensor goes through a reciprocal in torch, two roundings)."""
    return torch.full_like(t, c) / t


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """The float32 quotient t / c in one rounding (on the card torch
    divides by a Python number as a product with its reciprocal)."""
    return t / torch.full_like(t, c)


# ---------------------------------------------------------------------------
# sorting / partition helpers
# ---------------------------------------------------------------------------

def shuffle_sort(sp: SpeciesState, r: torch.Tensor):
    """Sort by voxel with the random tiebreak ``r`` (31-bit int32 per slot):
    a per-cell shuffle.  Dead lanes sort last, so live stays a prefix.  One
    stable sort of the int64 key voxel << 31 | r gives the permutation of
    the JAX package's ``lexsort((r, k))``.  Returns (sorted species with new
    tensors, the permutation)."""
    k = torch.where(sp.live, sp.i, _DEAD_KEY).to(torch.int64)
    order = torch.sort((k << 31) | r.to(torch.int64), stable=True).indices
    return sp.replace(**gather_sp_rows(order, sp)), order


def cell_partition(sp: SpeciesState, g: Grid):
    """(start[voxel], count[voxel]) over the sorted live prefix (the
    reference's sp->partition, species_advance_aos.h:74-80), int64."""
    key = torch.where(sp.live, sp.i, g.nv)
    vox = torch.arange(g.nv, dtype=key.dtype, device=key.device)
    start = torch.searchsorted(key, vox, side="left")
    end = torch.searchsorted(key, vox, side="right")
    return start, end - start


def _perp_vector(urx, ury, urz):
    """T1: unit vector perpendicular to ur, built by zeroing ur's smallest
    component and rotating the other two 90 degrees (hard_sphere.c:189-199)."""
    ax, ay, az = urx.abs(), ury.abs(), urz.abs()
    min_x = (ax <= ay) & (ax <= az)
    min_y = (~min_x) & (ay <= az)
    zero = torch.zeros_like(urx)
    tx = torch.where(min_x, zero, torch.where(min_y, -urz, -ury))
    ty = torch.where(min_x, -urz, torch.where(min_y, zero, urx))
    tz = torch.where(min_x, ury, torch.where(min_y, urx, zero))
    tn = torch.rsqrt(torch.clamp(tx * tx + ty * ty + tz * tz, min=1e-30))
    return tx * tn, ty * tn, tz * tn


def _deflect(urx, ury, urz, cos_t, sin_t, phi_c, phi_s):
    """Change in relative velocity for scattering by (theta, phi) about ur."""
    ur = torch.sqrt(urx * urx + ury * ury + urz * urz)
    t1x, t1y, t1z = _perp_vector(urx, ury, urz)
    # T2 = ur x T1 / |ur|
    inv = torch.rsqrt(torch.clamp(ur * ur, min=1e-30))
    t2x = (ury * t1z - urz * t1y) * inv
    t2y = (urz * t1x - urx * t1z) * inv
    t2z = (urx * t1y - ury * t1x) * inv
    px = phi_c * t1x + phi_s * t2x
    py = phi_c * t1y + phi_s * t2y
    pz = phi_c * t1z + phi_s * t2z
    dx = (cos_t - 1.0) * urx + sin_t * ur * px
    dy = (cos_t - 1.0) * ury + sin_t * ur * py
    dz = (cos_t - 1.0) * urz + sin_t * ur * pz
    return dx, dy, dz


def _phi(u):
    """The azimuth from a standard uniform, as jax.random.uniform(0, 2 pi)
    scales its draw."""
    phi = u * (2.0 * math.pi)
    return torch.cos(phi), torch.sin(phi)


# ---------------------------------------------------------------------------
# Binary collision framework
# ---------------------------------------------------------------------------

@dataclass
class BinaryModel:
    """A binary collision model: rate constant + scattering law
    (binary_collision_model analogue, collision.h:237-246).

    ``sample_angle(v, ur, params, pr) -> (cos_t, sin_t)`` takes ``v``, one
    standard variate of kind ``variate`` ("uniform" or "normal") per pair,
    where the JAX package's takes a key."""

    name: str
    # K(ur, params) -> rate constant (volume/time); ur = |u_i - u_j| * c
    rate_constant: Callable
    sample_angle: Callable
    params: dict
    # cumulative models (T&A) fold pr to 1 and carry the rate in the
    # scattering variance: exempt from large-pr tallies and sub-cycling
    saturates: bool = False
    variate: str = "uniform"


def make_binary_op(model: BinaryModel, spi_idx: int, spj_idx: int,
                   spi: SpeciesParams, spj: SpeciesParams,
                   sample: float = 1.0, interval: int = 1,
                   pr_rounds: int = 1, *, _ta_var: Optional[Callable] = None):
    """A collision op for ``Simulation.collision_ops``:
    ``op(species, f, g, step, generator, diag=None)`` returns the species
    list, or (species, diag) when given a diag dict, which then carries the
    count of candidates whose probability exceeded ``pr_rounds`` under
    ``coll_large_pr:<name>:<i>:<j>`` (none for a model that saturates).  It
    fires on the steps that are multiples of ``interval`` (never for
    interval <= 0).  ``pr_rounds`` > 1 sub-cycles each application into
    that many pairing + scatter rounds at pr / pr_rounds each
    (vpic_tpu/collision.py:128-147).

    ``op.draw(generator, species)`` -> a list of one dict of variates per
    round; ``op.apply(species, g, draws)`` -> (species, large-pr count, a
    0-d int32 tensor).  ``apply`` runs ops/ta_collide's kernels on CUDA
    tensors for a Takizuka-Abe op with one round (``_ta_var``, its
    sigma^2 v_r^3 from the model's params, passed by make_takizuka_abe_op
    alone, whose rate and angle the kernels compute as fixed arithmetic),
    else the plain op, ``op.apply_plain``; ``op.route`` is "cuda" or
    "plain", the route of the latest apply."""
    mi, mj = spi.m, spj.m
    mu = mi * mj / (mi + mj)
    intra = spi_idx == spj_idx
    if pr_rounds < 1:
        raise ValueError("pr_rounds must be >= 1")
    saturates = getattr(model, "saturates", False)
    if saturates and pr_rounds != 1:
        raise ValueError(
            f"{model.name}: cumulative models fold pr into the scattering "
            "strength; sub-cycling would double-count the rate")
    tally_key = f"coll_large_pr:{model.name}:{spi_idx}:{spj_idx}"
    tally = not saturates

    def draw(generator, species):
        ni = species[spi_idx].capacity
        dev = species[spi_idx].ux.device
        n = ni // 2 if intra else ni
        rounds = []
        for _ in range(pr_rounds):
            d = dict(shuf_i=shuffle_bits(generator, ni, dev))
            if not intra:
                d["shuf_j"] = shuffle_bits(generator, species[spj_idx]
                                           .capacity, dev)
            d["pr"] = variate(generator, "uniform", (n,), dev)
            d["phi"] = variate(generator, "uniform", (n,), dev)
            d["theta"] = variate(generator, model.variate, (n,), dev)
            d["bal"] = variate(generator, "uniform", (n,), dev)
            rounds.append(d)
        return rounds

    def one_round(species, d, g: Grid, count_large):
        si, _ = shuffle_sort(species[spi_idx], d["shuf_i"])
        sj = si if intra else shuffle_sort(species[spj_idx], d["shuf_j"])[0]
        start_i, cnt_i = cell_partition(si, g)
        start_j, cnt_j = (start_i, cnt_i) if intra else cell_partition(sj, g)
        N = si.capacity
        dtint_dV = g.dt * interval / g.dV
        if intra:
            # adjacent-slot pairs (2m, 2m+1) within the same voxel
            half = N // 2
            a, b = slice(0, 2 * half, 2), slice(1, 2 * half, 2)
            same = (si.i[a] == si.i[b]) & si.live[a] & si.live[b]
            nk = cnt_i[si.i[a].long()].to(torch.float32)
            npairs = 0.5 * nk * (nk + 1.0)
            ncand = torch.clamp(0.5 * nk * sample, min=1.0)
            pr_norm = dtint_dV * npairs / ncand
            ib = None
        else:
            # each live i-lane pairs with the (rank mod nl)-th j-lane of
            # its voxel
            a = slice(0, N)
            vox = si.i.long()
            rank = torch.arange(N, device=vox.device) - start_i[vox]
            nl = torch.clamp(cnt_j[vox], min=1)
            ib = start_j[vox] + rank % nl
            same = si.live & (cnt_j[vox] > 0)
            pr_norm = _div(dtint_dV * cnt_j[vox].to(torch.float32), sample)
            b = ib
        uix, uiy, uiz = si.ux[a], si.uy[a], si.uz[a]
        ujx, ujy, ujz = sj.ux[b], sj.uy[b], sj.uz[b]
        wi_, wj_ = si.w[a], sj.w[b]
        urx, ury, urz = uix - ujx, uiy - ujy, uiz - ujz
        ur = torch.sqrt(urx * urx + ury * ury + urz * urz) * g.cvac

        K = model.rate_constant(ur, model.params)
        w_max = torch.maximum(wi_, wj_)
        w_min = torch.minimum(wi_, wj_)
        pr_full = torch.where(same, w_max * pr_norm * K, 0.0)
        nlarge = ((pr_full > pr_rounds).sum(dtype=torch.int32)
                  if count_large else None)
        pr = _div(pr_full, pr_rounds)
        hit = d["pr"] < pr

        cos_t, sin_t = model.sample_angle(d["theta"], ur, model.params, pr)
        ddx, ddy, ddz = _deflect(urx, ury, urz, cos_t, sin_t,
                                 *_phi(d["phi"]))

        # detailed balance: always update the lighter computational
        # particle; the heavier with probability w_min/w_max
        upd_heavy = (d["bal"] * w_max) < w_min
        upd_i = hit & ((wi_ <= wj_) | upd_heavy)
        upd_j = hit & ((wj_ <= wi_) | upd_heavy)
        fi = torch.where(upd_i, mu / mi, 0.0)
        fj = torch.where(upd_j, mu / mj, 0.0)

        # si and sj hold new tensors (the shuffle's gather): update them in
        # place; the deltas above were computed before any update
        for u, du in ((si.ux, ddx), (si.uy, ddy), (si.uz, ddz)):
            u[a] += fi * du
        for u, du in ((sj.ux, ddx), (sj.uy, ddy), (sj.uz, ddz)):
            if intra:
                u[b] += -fj * du
            else:
                u.index_add_(0, ib, -fj * du)
        species = list(species)
        species[spi_idx] = si
        species[spj_idx] = sj
        return species, nlarge

    def apply_plain(species, g: Grid, draws):
        nlarge = torch.zeros((), dtype=torch.int32,
                             device=species[spi_idx].ux.device)
        for r, d in enumerate(draws):
            species, n = one_round(species, d, g, tally and r == 0)
            if n is not None:
                nlarge = nlarge + n
        return species, nlarge

    hand = _ta_var is not None and pr_rounds == 1

    def apply_cuda(species, g: Grid, draws):
        (d,) = draws
        c = TA.Constants(g.dt * interval / g.dV, sample, g.cvac,
                         _ta_var(model.params), mu / mi, mu / mj,
                         2.0 * math.pi)
        species = list(species)
        si = species[spi_idx]
        oi = TA.shuffle_order(si.live, si.i, d["shuf_i"], g.nv)
        if intra:
            species[spi_idx] = TA.collide(si, oi, None, None, d, c)
        else:
            sj = species[spj_idx]
            oj = TA.shuffle_order(sj.live, sj.i, d["shuf_j"], g.nv)
            species[spi_idx], species[spj_idx] = TA.collide(si, oi, sj, oj,
                                                            d, c)
        return species, torch.zeros((), dtype=torch.int32,
                                    device=si.ux.device)

    def apply(species, g: Grid, draws):
        if hand and species[spi_idx].ux.is_cuda:
            op.route = "cuda"
            return apply_cuda(species, g, draws)
        op.route = "plain"
        return apply_plain(species, g, draws)

    def op(species, f, g: Grid, step, generator, diag=None):
        species = list(species)
        fire = interval > 0 and int(step) % interval == 0
        n = None
        if fire:
            species, n = apply(species, g, draw(generator, species))
        if diag is None:
            return species
        diag = dict(diag)
        if tally:
            n0 = diag.get(tally_key)
            if n0 is None:
                n0 = torch.zeros((), dtype=torch.int32,
                                 device=species[spi_idx].ux.device)
            diag[tally_key] = n0 + n if fire else n0
        return species, diag

    op.has_diag = True
    op.interval = interval     # static cadence (residency invalidation)
    op.pair = (spi_idx, spj_idx)
    op.draw = draw
    op.apply = apply
    op.apply_plain = apply_plain
    op.route = None
    op.tally_key = tally_key if tally else None
    if tally:
        op.diag_init = lambda device="cpu": {
            tally_key: torch.zeros((), dtype=torch.int32, device=device)}
    return op


# ---------------------------------------------------------------------------
# Concrete binary models
# ---------------------------------------------------------------------------

def hard_sphere_model(radius_i: float, radius_j: float) -> BinaryModel:
    """Hard-sphere scattering (hard_sphere.c:99-124): K = pi R^2 |vr|;
    cos(theta) = 2 (b/R)^2 - 1 from a uniform (b/R)^2."""
    R = radius_i + radius_j
    Kc = math.pi * R * R

    def rate(ur, p):
        return Kc * ur

    def angle(b2, ur, p, pr):
        cos_t = 2.0 * b2 - 1.0
        sin_t = 2.0 * torch.sqrt(torch.clamp(b2 * (1.0 - b2), min=0.0))
        return cos_t, sin_t

    return BinaryModel("hard sphere", rate, angle, dict(R=R))


def _rutherford(u, ur, bmax, pre):
    """(cos, sin) of tan(theta/2) = b0 / (2 b), b uniform in area on
    [0, bmax] from the uniform ``u``."""
    b = bmax * torch.sqrt(u)
    # b0/2 = q_i q_j / (4 pi eps0 mu vr^2): 90-degree impact parameter
    half_b0 = _rdiv(pre, torch.clamp(ur * ur, min=1e-30))
    t = half_b0 / torch.clamp(b, min=1e-30)  # tan(theta/2)
    return (1.0 - t * t) / (1.0 + t * t), 2.0 * t / (1.0 + t * t)


def large_angle_coulomb_model(q_i: float, q_j: float, m_i: float, m_j: float,
                              eps0: float = 1.0,
                              bmax: float = 1.0) -> BinaryModel:
    """Rutherford scattering with an impact-parameter cutoff
    (large_angle_coulomb.c, API collision.h:282-306): collisions with
    b < bmax at rate K = pi bmax^2 |vr|."""
    mu = m_i * m_j / (m_i + m_j)
    pre = abs(q_i * q_j) / (4.0 * math.pi * eps0 * mu)

    def rate(ur, p):
        return math.pi * bmax * bmax * ur

    def angle(u, ur, p, pr):
        return _rutherford(u, ur, bmax, pre)

    return BinaryModel("large angle coulomb", rate, angle,
                       dict(bmax=bmax, pre=pre))


def make_takizuka_abe_op(spi_idx: int, spj_idx: int, spi: SpeciesParams,
                         spj: SpeciesParams, g: Grid, nu0_dt: float = None,
                         log_lambda: float = 10.0, n0: float = 1.0,
                         interval: int = 1, sample: float = 1.0):
    """Takizuka & Abe (J. Comput. Phys. 25, 205 (1977)) cumulative
    small-angle Coulomb pair collisions: every sampled pair scatters with
    tan(theta/2) = delta, delta ~ N(0, var),
    var = (qi qj)^2 n log_lambda dt / (8 pi eps0^2 mu^2 vr^3); ``n`` is
    ``n0``.  Its variate is a standard normal."""
    mi, mj = spi.m, spj.m
    mu = mi * mj / (mi + mj)
    qi, qj = spi.q, spj.q
    pref = ((qi * qj) ** 2) * log_lambda / \
        (8.0 * math.pi * g.eps0 ** 2 * mu ** 2)

    def var_scale(p):
        return pref * p["n_local"] * g.dt * interval

    def rate(ur, p):
        # every sampled pair "collides": a rate that saturates the
        # probability (w_max * pr_norm * 1e30 stays finite in float32)
        return torch.full_like(ur, 1e30)

    def angle(normal, ur, p, pr):
        m = torch.clamp(ur, min=1e-12)
        var = _rdiv(var_scale(p), m * m * m)
        delta = torch.sqrt(var) * normal
        # comoving pairs do not scatter; huge delta is full backscatter
        delta = torch.where(ur > 1e-12, torch.clamp(delta, -1e3, 1e3), 0.0)
        cos_t = (1.0 - delta * delta) / (1.0 + delta * delta)
        sin_t = 2.0 * delta / (1.0 + delta * delta)
        return cos_t, sin_t

    model = BinaryModel("takizuka-abe", rate, angle, dict(n_local=n0),
                        saturates=True, variate="normal")
    return make_binary_op(model, spi_idx, spj_idx, spi, spj,
                          sample=sample, interval=interval, _ta_var=var_scale)


# ---------------------------------------------------------------------------
# Unary collision framework + Langevin
# ---------------------------------------------------------------------------

def _draw_variates(generator, spec: dict, n: int, device) -> dict:
    """{name: variates} for a spec {name: (kind, rows)}: (n,) when rows is
    0, else (rows, n)."""
    return {name: variate(generator, kind, (rows, n) if rows else (n,),
                          device)
            for name, (kind, rows) in spec.items()}


def make_unary_op(sp_idx: int, rate_constant: Callable, collide: Callable,
                  interval: int = 1):
    """unary_collision_model (unary.c, API collision.h:122-129): each live
    particle collides against a fixed background with probability
    dt * interval * K(u).  ``collide(v, ux, uy, uz, hit) -> (ux, uy, uz)``
    takes ``v``, a dict of standard variates made from the spec
    ``collide.variates``: {name: (kind, rows)}, each
    (capacity,) when rows is 0, else (rows, capacity); by default one
    (3, capacity) normal named "normal".  The JAX package's callback takes
    a key instead.  ``op(species, f, g, step, generator)`` -> species;
    ``op.draw(generator, species)`` and ``op.apply(species, g, draws)``."""
    spec = getattr(collide, "variates", {"normal": ("normal", 3)})

    def draw(generator, species):
        sp = species[sp_idx]
        return dict(hit=variate(generator, "uniform", (sp.capacity,),
                                sp.ux.device),
                    collide=_draw_variates(generator, spec, sp.capacity,
                                           sp.ux.device))

    def apply(species, g: Grid, draws):
        species = list(species)
        sp = species[sp_idx]
        K = rate_constant(sp.ux, sp.uy, sp.uz, g)
        pr = torch.where(sp.live, K * g.dt * interval, 0.0)
        hit = draws["hit"] < pr
        ux, uy, uz = collide(draws["collide"], sp.ux, sp.uy, sp.uz, hit)
        species[sp_idx] = sp.replace(ux=ux, uy=uy, uz=uz)
        return species

    def op(species, f, g: Grid, step, generator):
        if interval <= 0 or int(step) % interval:
            return list(species)
        return apply(species, g, draw(generator, species))

    op.interval = interval     # static cadence (residency invalidation)
    op.draw = draw
    op.apply = apply
    return op


def hard_sphere_fluid_rate(n_bg: float, radius: float, vd=(0.0, 0.0, 0.0),
                           kT_over_m: float = 0.0):
    """hard_sphere_fluid_rate_constant (hard_sphere.c:99-110): Pade fit of
    the drifting-Maxwellian-averaged rate K = n pi R^2 <|vr|>."""
    a = 8.0 / math.pi
    b = 4.0 / (12.0 - 3.0 * math.pi)
    gma = (3.0 * math.pi - 8.0) / (24.0 - 6.0 * math.pi)
    ut2 = kT_over_m
    Kt2 = (n_bg * math.pi * radius * radius) ** 2

    def rate(ux, uy, uz, g: Grid):
        urx = ux * g.cvac - vd[0]
        ury = uy * g.cvac - vd[1]
        urz = uz * g.cvac - vd[2]
        ur2 = urx * urx + ury * ury + urz * urz
        return torch.sqrt((a * Kt2 * ut2 * ut2
                           + ur2 * (b * Kt2 * ut2 + ur2 * gma * Kt2))
                          / torch.clamp(ut2 + ur2 * gma, min=1e-30))

    return rate


def make_langevin_op(sp_idx: int, sp: SpeciesParams, kT: float, nu: float,
                     interval: int = 1):
    """langevin.c: Ornstein-Uhlenbeck kick u <- decay u + drive N(0, 1),
    decay = exp(-nu dt interval), drive = sqrt((1 - decay^2) kT / (m c^2))
    (langevin_pipeline.c:54-89).  Its variates: a (3, capacity) normal."""

    def draw(generator, species):
        s = species[sp_idx]
        return dict(normal=variate(generator, "normal", (3, s.capacity),
                                   s.ux.device))

    def apply(species, g: Grid, draws):
        decay = math.exp(-nu * g.dt * interval)
        drive_sq = (1.0 - decay * decay) * kT / (sp.m * g.cvac * g.cvac)
        drive = math.sqrt(drive_sq)
        species = list(species)
        s = species[sp_idx]
        r = draws["normal"]
        upd = lambda u, n: torch.where(s.live, decay * u + drive * n, u)
        species[sp_idx] = s.replace(ux=upd(s.ux, r[0]), uy=upd(s.uy, r[1]),
                                    uz=upd(s.uz, r[2]))
        return species

    def op(species, f, g: Grid, step, generator):
        if interval <= 0 or int(step) % interval:
            return list(species)
        return apply(species, g, draw(generator, species))

    op.interval = interval     # static cadence (residency invalidation)
    op.draw = draw
    op.apply = apply
    return op


def _fluid_collide(uth_bg, vd, mu_over_mi, mu_over_mbg, angle_fn):
    """Unary collide callback: a background partner from a drifting
    Maxwellian (the "ub" normals), scattered elastically by ``angle_fn``
    (its "angle" uniform) about a "phi" uniform; only the test particle's
    update is kept (the background is a fixed fluid, unary.c semantics)."""

    def collide(v, ux, uy, uz, hit):
        ub = uth_bg * v["ub"]
        urx = ux - (ub[0] + vd[0])
        ury = uy - (ub[1] + vd[1])
        urz = uz - (ub[2] + vd[2])
        ur = torch.sqrt(urx * urx + ury * ury + urz * urz)
        cos_t, sin_t = angle_fn(v["angle"], ur)
        ddx, ddy, ddz = _deflect(urx, ury, urz, cos_t, sin_t, *_phi(v["phi"]))
        return (torch.where(hit, ux + mu_over_mi * ddx, ux),
                torch.where(hit, uy + mu_over_mi * ddy, uy),
                torch.where(hit, uz + mu_over_mi * ddz, uz))

    collide.variates = {"ub": ("normal", 3), "angle": ("uniform", 0),
                        "phi": ("uniform", 0)}
    return collide


def make_hard_sphere_fluid_op(sp_idx: int, spp: SpeciesParams,
                              n_bg: float, radius: float, m_bg: float,
                              kT_bg: float = 0.0, vd=(0.0, 0.0, 0.0),
                              interval: int = 1):
    """hard_sphere fluid model (hard_sphere.c:99-110 + unary framework):
    test particles scatter off a fixed drifting-Maxwellian hard-sphere
    background."""
    mu_i = m_bg / (spp.m + m_bg)       # mu / m_i
    uth = math.sqrt(kT_bg / m_bg) if kT_bg > 0 else 0.0
    rate = hard_sphere_fluid_rate(n_bg, radius, vd, kT_bg / m_bg
                                  if m_bg > 0 else 0.0)

    def angle(b2, ur):
        return 2.0 * b2 - 1.0, 2.0 * torch.sqrt(torch.clamp(
            b2 * (1.0 - b2), min=0.0))

    return make_unary_op(sp_idx, rate,
                         _fluid_collide(uth, vd, mu_i, None, angle),
                         interval=interval)


def make_large_angle_coulomb_fluid_op(sp_idx: int, spp: SpeciesParams,
                                      n_bg: float, q_bg: float, m_bg: float,
                                      kT_bg: float = 0.0,
                                      vd=(0.0, 0.0, 0.0), bmax: float = 1.0,
                                      eps0: float = 1.0, interval: int = 1):
    """large_angle_coulomb fluid model (large_angle_coulomb.c + unary
    framework): Rutherford scattering with an impact-parameter cutoff off a
    fixed background."""
    mu = spp.m * m_bg / (spp.m + m_bg)
    mu_i = m_bg / (spp.m + m_bg)
    pre = abs(spp.q * q_bg) / (4.0 * math.pi * eps0 * mu)
    uth = math.sqrt(kT_bg / m_bg) if kT_bg > 0 else 0.0

    def rate(ux, uy, uz, g: Grid):
        urx = ux * g.cvac - vd[0]
        ury = uy * g.cvac - vd[1]
        urz = uz * g.cvac - vd[2]
        ur = torch.sqrt(urx * urx + ury * ury + urz * urz)
        return n_bg * math.pi * bmax * bmax * ur

    def angle(u, ur):
        return _rutherford(u, ur, bmax, pre)

    return make_unary_op(sp_idx, rate,
                         _fluid_collide(uth, vd, mu_i, None, angle),
                         interval=interval)
