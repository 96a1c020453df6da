"""Bit-exact reimplementation of the reference's random stream.

The reference's committed gold energy history
(test/unit/energy_comparison/energies_gold) was produced from an initial
particle load drawn from VPIC's own RNG (SFMT-11213 + ziggurat normals,
src/util/rng/rng.c, rng_private.h).  Cross-implementation energy parity at
the reference's per-step tolerances (compare_energies.h: 3% on B sums) is
only meaningful if the initial conditions are IDENTICAL, so this module
reproduces that stream bit-for-bit:

- SFMT-11213 state update (rng_private.h:105-116 parameter set, the
  portable SFMT() recurrence at rng_private.h:228-244).
- seed_rng's Knuth-style state fill + parity adjustment (rng.c:43-74).
- The byte-counter extraction semantics of RNG_NEXT (rng_private.h:264-270):
  draws of different widths share one byte-addressed state, aligned up.
- conv_drand* lattice-rounding conversions (rng_private.h:292-295).
- drandn's 256-level ziggurat (rng.c:350-394).  The zig_x/zig_y tables are
  REGENERATED here from the published construction (rng.c:148-290 explains
  it: equal-area strips + exponential tail, R solved by bisection) rather
  than copied from drandn_table.c.
- The deck-level helpers uniform()/normal() (vpic.h:587-595) and the pool
  seeding arithmetic seed_rng_pool (rng_pool.c:53-62) / seed_entropy
  (vpic.h:579-582).

Everything is host-side numpy; this feeds deck initialisation only.
"""

import functools
import math

import numpy as np

_M32 = 0xFFFFFFFF

# SFMT-11213 parameter set (rng_private.h:105-116)
_N = 11213 // 128 + 1          # 88 x 128-bit state vectors
_M = 68
_L1, _L2, _R1, _R2 = 14, 3, 7, 3
_MASK = (0xEFFFF7FB, 0xFFFFFFEF, 0xDFDFBFFF, 0x7FFFDBFD)
_PARITY = (0x00000001, 0x00000000, 0xE8148000, 0xD0C7AFA3)
_NC = _N * 16                  # state bytes
_N64 = _NC // 8


def _sfmt_next(u32):
    """One full-state SFMT pass over the (4*_N,) uint32 state, in place.
    Portable recurrence of rng_private.h:228-244: w128 little-endian lanes,
    128-bit byte shifts L2/R2 and per-lane bit shifts R1/L1."""
    L2A, R2A = 8 * _L2, 8 * _R2
    L2B, R2B = 32 - L2A, 32 - R2A
    s = u32

    def step(n, m, c, d):
        a0, a1, a2, a3 = s[4 * n:4 * n + 4]
        b = s[4 * m:4 * m + 4]
        cc = s[4 * c:4 * c + 4]
        dd = s[4 * d:4 * d + 4]
        x0 = (a0 << L2A) & _M32
        x1 = ((a1 << L2A) | (a0 >> L2B)) & _M32
        x2 = ((a2 << L2A) | (a1 >> L2B)) & _M32
        x3 = ((a3 << L2A) | (a2 >> L2B)) & _M32
        y0 = ((cc[0] >> R2A) | (cc[1] << R2B)) & _M32
        y1 = ((cc[1] >> R2A) | (cc[2] << R2B)) & _M32
        y2 = ((cc[2] >> R2A) | (cc[3] << R2B)) & _M32
        y3 = cc[3] >> R2A
        s[4 * n + 0] = a0 ^ (x0 ^ ((b[0] >> _R1) & _MASK[0])) \
            ^ (y0 ^ ((dd[0] << _L1) & _M32))
        s[4 * n + 1] = a1 ^ (x1 ^ ((b[1] >> _R1) & _MASK[1])) \
            ^ (y1 ^ ((dd[1] << _L1) & _M32))
        s[4 * n + 2] = a2 ^ (x2 ^ ((b[2] >> _R1) & _MASK[2])) \
            ^ (y2 ^ ((dd[2] << _L1) & _M32))
        s[4 * n + 3] = a3 ^ (x3 ^ ((b[3] >> _R1) & _MASK[3])) \
            ^ (y3 ^ ((dd[3] << _L1) & _M32))

    step(0, _M, _N - 2, _N - 1)
    step(1, _M + 1, _N - 1, 0)
    for n in range(2, _N - _M):
        step(n, n + _M, n - 2, n - 1)
    for n in range(_N - _M, _N):
        step(n, n - (_N - _M), n - 2, n - 1)


@functools.lru_cache(maxsize=None)
def _drandn_tables():
    """Regenerate drandn's 256-level ziggurat partition (rng.c:148-290).

    Equal-area construction: v = r*f(r) + exp(-r^2/2)/r, x_{N-1} = r,
    f(x_i) = f(x_{i+1}) + v/x_{i+1} descending to x_0 = 0; r is the root
    where the construction closes (f(x_1) + v/x_1 == f(0) == 1).  Run in
    40+-digit decimal arithmetic then rounded to double so the table is
    bit-identical to the reference's high-precision-generated constants
    (drandn_table.c prints 40 decimal digits); a double-only recurrence
    lands 1-2 ulps off, which perturbs every drandn deviate."""
    import decimal
    D = decimal.Decimal
    ctx = decimal.getcontext()
    ctx.prec = 50
    N = 256
    half = D("0.5")

    def f(x):
        return (-half * x * x).exp()

    def build(r):
        v = r * f(r) + f(r) / r
        x = [D(0)] * (N + 1)
        x[N] = v / f(r)
        x[N - 1] = r
        y = f(r)
        for i in range(N - 2, 0, -1):
            y = y + v / x[i + 1]
            if y >= 1:
                return x, y - 1
            x[i] = (D(-2) * y.ln()).sqrt()
        return x, (y + v / x[1]) - 1

    lo, hi = D("3.65"), D("3.66")
    for _ in range(180):
        mid = (lo + hi) * half
        _, err = build(mid)
        # err > 0: construction overshoots f(0) -> r too small
        if err > 0:
            lo = mid
        else:
            hi = mid
    r = (lo + hi) * half
    x, _ = build(r)
    zig_x = np.array([float(xi) for xi in x])
    zig_y = np.array([float(f(xi)) for xi in x[:257]])
    return zig_x, zig_y, float(r)


class VpicRng:
    """One reference-rng generator (struct rng, rng_private.h:246-260)."""

    def __init__(self, seed: int):
        self.u32 = np.zeros(4 * _N, dtype=np.uint64)  # u64 math, 32-bit vals
        self.seed(seed)

    # --- seeding (rng.c:43-74) ---
    def seed(self, seed: int):
        u = self.u32
        u[0] = np.uint64(seed & _M32)
        for n in range(1, 4 * _N):
            prev = int(u[n - 1])
            u[n] = (1812433253 * (prev ^ (prev >> 30)) + n) & _M32
        # period-certification parity adjustment
        bit = 0
        for n in range(4):
            bit ^= int(u[n]) & _PARITY[n]
        bit ^= bit >> 16
        bit ^= bit >> 8
        bit ^= bit >> 4
        bit ^= bit >> 2
        bit ^= bit >> 1
        if not (bit & 1):
            for n in range(4):
                p = _PARITY[n]
                if p:
                    u[n] = np.uint64(int(u[n]) ^ (p & -p))
                    break
        self.n = _NC  # next unextracted byte: force sfmt_next on first draw

    # --- extraction (RNG_NEXT, rng_private.h:264-270) ---
    def _next_u64(self):
        n = (self.n + 7) & ~7
        if n >= _NC:
            _sfmt_next(self.u32)
            n = 0
        i = n // 8
        a = int(self.u32[2 * i]) | (int(self.u32[2 * i + 1]) << 32)
        self.n = n + 8
        return a

    def _next_u32(self):
        n = (self.n + 3) & ~3
        if n >= _NC:
            _sfmt_next(self.u32)
            n = 0
        a = int(self.u32[n // 4])
        self.n = n + 4
        return a

    # --- uniform doubles (conv_drand*, rng_private.h:292-295) ---
    def drand(self):
        return ((self._next_u64() >> 12) + 0.5) * (2.0 / 9007199254740992.0)

    def drand_c0(self):
        return (self._next_u64() >> 11) * (1.0 / 9007199254740992.0)

    def drand_c1(self):
        return ((self._next_u64() >> 11) + 1) * (1.0 / 9007199254740992.0)

    def drand_c(self):
        a = self._next_u64()
        return ((a >> 11) + (a & 1)) * (1.0 / 9007199254740992.0)

    # --- ziggurat normal (drandn, rng.c:350-394) ---
    def drandn(self):
        zig_x, zig_y, R = _drandn_tables()
        scale = 1.0 / 1.8446744073709551616e+19
        while True:
            a = self._next_u64()
            s = a & 0x1
            i = (a & 0x1FE) >> 1
            j = (a & 0x400) << 1
            j = (a & ~0x3FF & (2**64 - 1)) + j
            x = j * (scale * zig_x[i + 1])
            if x < zig_x[i]:
                break
            a = self._next_u64()
            y = ((a >> 11) + (a & 1)) * (1.0 / 9007199254740992.0)  # drand_c
            if i != 255:
                y = zig_y[i] + (zig_y[i + 1] - zig_y[i]) * y
            else:
                a = self._next_u64()
                c1 = ((a >> 11) + 1) * (1.0 / 9007199254740992.0)
                x = R - (1.0 / R) * math.log(c1)
                y *= math.exp(-R * (x - 0.5 * R))
            if y < math.exp(-0.5 * x * x):
                break
        return -x if s else x

    # --- deck helpers (vpic.h:587-595) ---
    def uniform(self, low, high):
        dx = self.drand()
        return low * (1 - dx) + high * dx

    def normal(self, mu, sigma):
        return mu + sigma * self.drandn()


def entropy_rng(base_seed: int, n_rng: int, rank: int = 0,
                world_size: int = 1, index: int = 0,
                sync: bool = False) -> VpicRng:
    """rng(index) of the entropy pool after seed_entropy(base_seed).

    Pool seeding arithmetic of seed_rng_pool (rng_pool.c:53-62):
      seed = (sync ? world_size : world_rank)
             + (world_size+1) * n_rng * base_seed
      rng[n] <- seed + (world_size+1) * n
    n_rng is pipeline-count + 1 (vpic.cc:84-102), i.e. build/run-thread
    dependent; callers pin it to whatever produced the data being matched.
    """
    seed = (world_size if sync else rank) \
        + (world_size + 1) * n_rng * base_seed
    return VpicRng(seed + (world_size + 1) * index)
