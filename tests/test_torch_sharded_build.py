"""The models decomposed: each rank of the port builds what vpic_tpu's
sharded build holds for that shard -- the per-shard capacities, the staged
lanes (vpic_tpu/deck.py:696-775's binning), the initial fields and the
region tables -- rank by rank.  Staging needs no collective, so each rank
runs in this process under a local Mesh."""

import numpy as np
import pytest

import vpic_tpu_torch.grid as GT
from vpic_tpu.models import harris as HJ
from vpic_tpu.models import lpi as LJ
from vpic_tpu.models import sc08 as SJ
from vpic_tpu.models import weibel as WJ
from vpic_tpu_torch.models import harris as HT
from vpic_tpu_torch.models import lpi as LT
from vpic_tpu_torch.models import sc08 as ST
from vpic_tpu_torch.models import weibel as WT
from vpic_tpu_torch.parallel import mesh as M
from vpic_tpu_torch.state import SPECIES_NAMES
from torch_parity import np_

CASES = {
    "harris": (HJ, HT, "HarrisParams",
               dict(nx=16, ny=16, nppc=4, Lx=8.0, Ly=8.0), (1, 2, 1)),
    "weibel": (WJ, WT, "WeibelParams",
               dict(nx=8, ny=8, nppc=4, Lx=4.0, Ly=4.0), (2, 2, 1)),
    "lpi": (LJ, LT, "LPIParams", dict(nx=32, ny=8, nppc=2, Lx=8.0, Ly=2.0,
                                      slab_x0=4.0), (2, 2, 1)),
    "sc08": (SJ, ST, "SC08Params", dict(nx=12, ny=5, nz=8, nppc=2),
             (1, 1, 4)),
}


@pytest.mark.parametrize("deck", sorted(CASES))
def test_rank_build_matches_vpic_tpu_shard(deck):
    mj, mt, cls, kw, topology = CASES[deck]
    sj = mj.build(getattr(mj, cls)(**kw, topology=topology))
    spj, urbj, _ = sj._pack_species()
    fj = sj._build_initial_fields()
    n = int(np.prod(topology))
    for r in range(n):
        with M.use(M.Mesh(r, n, "cpu", "local")):
            st = mt.build(getattr(mt, cls)(**kw, topology=topology),
                          device="cpu")
            g = st.grid
            assert g.topology == sj.grid.topology
            assert g.field_bc == sj.grid.field_bc
            assert g.particle_bc == sj.grid.particle_bc
            idx = GT.rank_coords(g, r)
            assert [s.params.capacity for s in st.species] == \
                [s.params.capacity for s in sj.species]
            spt, urbt, _ = st._pack_species()
            for a, b, ua, ub in zip(spj, spt, urbj, urbt):
                for name in SPECIES_NAMES:
                    x = np.asarray(getattr(a, name))[idx]
                    np.testing.assert_array_equal(x, np_(getattr(b, name)),
                                                  err_msg=f"{deck} {name}")
                np.testing.assert_array_equal(np.asarray(ua)[idx], np_(ub))
            ft = st._build_initial_fields()
            for name in ("ex", "ey", "ez", "cbx", "cby", "cbz"):
                np.testing.assert_array_equal(
                    np.asarray(getattr(fj, name))[idx],
                    np_(getattr(ft, name)), err_msg=f"{deck} {name}")
