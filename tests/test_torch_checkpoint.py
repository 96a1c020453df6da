"""The port's checkpoint / restart (vpic_tpu_torch/checkpoint.py) on the
CPU, where the plain versions are deterministic: checkpoint -> restore ->
steps is bit for bit the uninterrupted run on the 2-D kernel path (weibel,
across a sort step) and on the 3-D residency path (16^3 harris: no extra
rebucket at the restore); a checkpoint without the residency keys restores
with _res_valid False and rebuckets at the first step; the generator state
rides along; modify and checksum; the diag keys are those vpic_tpu's
initialize() makes for the deck, and vpic_tpu's restore reads them.  The
states that cross between the packages are held in
tests/test_torch_checkpoint_jax.py."""

import numpy as np
import pytest
import torch

from vpic_tpu import checkpoint as CJ
from vpic_tpu.models import harris as harris_jax
from vpic_tpu_torch import checkpoint as CK
from vpic_tpu_torch.models import harris, weibel
from vpic_tpu_torch.state import FIELD_NAMES, SPECIES_NAMES

torch.set_num_threads(2)

WEIBEL = dict(nx=8, ny=8, nppc=8, Lx=4.0, Ly=4.0, seed=3)
HARRIS3D = dict(nx=16, ny=16, nz=16, nppc=2, Lx=8.0, Ly=8.0, Lz=8.0,
                headroom=6.0)


def assert_states_equal(a, b):
    assert a.step == b.step
    for n in FIELD_NAMES:
        assert torch.equal(getattr(a.fields, n), getattr(b.fields, n)), n
    for sa, sb in zip(a.species, b.species):
        for n in SPECIES_NAMES:
            assert torch.equal(getattr(sa, n), getattr(sb, n)), n
    assert a.diag.keys() == b.diag.keys()
    for k, v in a.diag.items():
        w = b.diag[k]
        assert (torch.equal(v, w) if isinstance(v, torch.Tensor)
                else v == w), k


def snapshot(state):
    """A copy of ``state`` the steps cannot touch (they update the field,
    and on the residency path the species, tensors in place)."""
    c = lambda v: v.clone() if isinstance(v, torch.Tensor) else v
    return state.replace(
        fields=state.fields.replace(**{n: c(getattr(state.fields, n))
                                       for n in FIELD_NAMES}),
        species=tuple(sp.replace(**{n: c(getattr(sp, n))
                                    for n in SPECIES_NAMES})
                      for sp in state.species),
        diag={k: c(v) for k, v in state.diag.items()})


def _run(step, state, n):
    for _ in range(n):
        state = step(state)
    return state


def test_weibel_restart_bit_equal(tmp_path):
    sim = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    state = _run(sim.make_step(), sim.initialize(), 5)
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    assert base == str(tmp_path / "ck") + ".5"
    # 5 more steps cross the sort at step 8
    cont = _run(sim.make_step(), snapshot(state), 5)

    sim2 = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    sim2.num_step = 0
    back = CK.restore(base, sim=sim2)
    assert sim2.num_step == sim.num_step
    assert_states_equal(back, state)
    assert np.array_equal(back.rng, state.rng)
    assert CK.checksum(back) == CK.checksum(state) != CK.checksum(cont)
    assert_states_equal(_run(sim2.make_step(), back, 5), cont)


@pytest.fixture(scope="module")
def harris3d():
    sim = harris.build(harris.HarrisParams(**HARRIS3D), device="cpu")
    assert sim._residency_mode()[0]
    state = _run(sim.make_step(), sim.initialize(), 3)
    assert state.diag["_res_valid"] is True
    return sim, state


def test_residency_restart_bit_equal(harris3d, tmp_path):
    sim, state = harris3d
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    data = np.load(base + ".npz")
    assert data["diag::_res_valid"].dtype == np.int32
    assert int(data["diag::_res_valid"]) == 1
    assert "diag::unfinished" not in data.files
    assert "torch::diag::unfinished" in data.files
    cont = _run(sim.make_step(), snapshot(state), 3)
    sim2 = harris.build(harris.HarrisParams(**HARRIS3D), device="cpu")
    back = CK.restore(base, sim=sim2)
    assert back.diag["_res_valid"] is True
    assert_states_equal(back, state)
    rerun = _run(sim2.make_step(), back, 3)
    assert int(rerun.diag["_res_rebuckets"]) == \
        int(state.diag["_res_rebuckets"]) == int(cont.diag["_res_rebuckets"])
    assert_states_equal(rerun, cont)


def test_checkpoint_without_residency_keys_rebuckets(harris3d, tmp_path):
    sim, state = harris3d
    base = CK.checkpt(state, str(tmp_path / "ck"), sim=sim)
    data = dict(np.load(base + ".npz"))
    for k in list(data):
        if k.startswith("diag::_"):
            del data[k]
    np.savez_compressed(base + ".npz", **data)
    sim2 = harris.build(harris.HarrisParams(**HARRIS3D), device="cpu")
    back = CK.restore(base, sim=sim2)
    assert back.diag.keys() == state.diag.keys()
    assert back.diag["_res_valid"] is False
    assert int(back.diag["_res_rebuckets"]) == 0
    nxt = sim2.make_step()(back)
    assert nxt.diag["_res_valid"] is True
    assert int(nxt.diag["_res_rebuckets"]) == 0   # the first step's sort
    assert [int(sp.np) for sp in nxt.species] == \
        [int(sp.np) for sp in state.species]


def test_generator_state_restored(tmp_path):
    sim = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    state = sim.initialize()
    torch.rand(7, generator=sim._generator)
    base = CK.checkpt(state, str(tmp_path / "ck"), tag="g", sim=sim)
    want = torch.rand(5, generator=sim._generator)
    sim2 = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    CK.restore(base, sim=sim2)
    assert torch.equal(torch.rand(5, generator=sim2._generator), want)
    # without the port's keys (a JAX checkpoint) the deck's seed reseeds it
    data = dict(np.load(base + ".npz"))
    del data["torch::generator"]
    np.savez_compressed(base + ".npz", **data)
    CK.restore(base, sim=sim2)
    fresh = torch.Generator().manual_seed(sim2.seed)
    assert torch.equal(torch.rand(5, generator=sim2._generator),
                       torch.rand(5, generator=fresh))


def test_restore_checks_the_grid(tmp_path):
    sim = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    base = CK.checkpt(sim.initialize(), str(tmp_path / "ck"), sim=sim)
    other = weibel.build(weibel.WeibelParams(**dict(WEIBEL, nx=4, nppc=1)),
                         device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        CK.restore(base, sim=other)
    state = CK.restore(base, device="cpu")
    assert state.step == 0 and len(state.species) == 2


def test_modify_and_checksum(tmp_path):
    sim = weibel.build(weibel.WeibelParams(**WEIBEL), device="cpu")
    f = tmp_path / "mod"
    f.write_text("num_step 123\nclean_div_e_interval 7\nbogus 1\n"
                 "status_interval 2.0\n")
    CK.modify(sim, str(f))
    assert (sim.num_step, sim.clean_div_e_interval, sim.status_interval) \
        == (123, 7, 2)
    state = sim.initialize()
    assert CK.checksum(state) == CK.checksum(state)
    # the step updates the state's tensors in place: take the sum first
    before = CK.checksum(state)
    assert CK.checksum(sim.make_step()(state)) != before


def test_residency_diag_keys_match_jax(tmp_path):
    """The 16^3 harris residency deck: the port's checkpoint holds exactly
    the diag keys, shapes and dtypes vpic_tpu's initialize() makes for its
    3-D kernel path with residency (the TPU's default, forced on the
    CPU), and vpic_tpu's restore reads them back."""
    kw = dict(nx=16, ny=16, nz=16, nppc=4, Lx=8.0, Ly=8.0, Lz=8.0,
              headroom=6.0)
    sj = harris_jax.build(harris_jax.HarrisParams(**kw))
    sj.use_pallas = True
    sj.pallas_residency = True
    st = harris.build(harris.HarrisParams(**kw), device="cpu")
    a = sj.initialize()
    dj = a.diag
    b = st.initialize()
    np.testing.assert_array_equal(b.rng, np.asarray(a.rng))
    base = CK.checkpt(b, str(tmp_path / "ck"), sim=st)
    data = np.load(base + ".npz")
    dt = {k[len("diag::"):]: data[k] for k in data.files
          if k.startswith("diag::")}
    assert dt.keys() == dj.keys()
    for k, v in dj.items():
        assert dt[k].shape == np.shape(v) and dt[k].dtype == np.asarray(
            v).dtype, k
    assert int(dt["_res_valid"]) == 0 and "_res_rebuckets" in dt
    back = CJ.restore(base, sim=sj)
    assert back.diag.keys() == dj.keys()
