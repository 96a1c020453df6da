"""The port's dumps (vpic_tpu_torch/dump.py) on the CPU against vpic_tpu's
for the same state carried across (the initial weibel state; the shapes
deck's fields for the material ids).  Byte for byte: fields (with material
ids), grid, materials, species, the strided field dump and its global
header, every V0 header; the floats the port computes itself to stated
tolerances: hydro to 1e-5 max|moment| (the sums run in another order), the
centred momenta of the particle dump to the center_p tolerances of
tests/test_torch_sort_moments.py (1e-5 relative + 5e-7), the energies to
1e-6 of their sum.  Each binary file is read back by
utilities/read_dumps.py, loaded by path."""

import importlib.util
import os
import struct

import numpy as np
import pytest
import torch

from vpic_tpu import dump as DJ
from vpic_tpu.models import shapes as shapes_jax
from vpic_tpu.models import weibel as weibel_jax
from vpic_tpu_torch import dump as DT
from vpic_tpu_torch.models import shapes as shapes_torch
from vpic_tpu_torch.models import weibel as weibel_torch
from vpic_tpu_torch.native import io as NIO
from vpic_tpu_torch.ops import hydro as HT

from torch_parity import np_, to_torch

torch.set_num_threads(2)

WEIBEL = dict(nx=8, ny=8, nppc=8, Lx=4.0, Ly=4.0, seed=3)
HDR = len(DT._header_v0(weibel_torch.build(
    weibel_torch.WeibelParams(nx=2, ny=2, nppc=1), device="cpu").grid, 0, 0))


def _reader():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "utilities", "read_dumps.py")
    spec = importlib.util.spec_from_file_location("read_dumps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RD = _reader()


@pytest.fixture(scope="module")
def pair():
    sj = weibel_jax.build(weibel_jax.WeibelParams(**WEIBEL))
    st = weibel_torch.build(weibel_torch.WeibelParams(**WEIBEL),
                            device="cpu")
    a = sj.initialize()
    return sj, st, a, to_torch(a)


def _bytes(names):
    assert len(names) == 1
    with open(names[0], "rb") as fh:
        return fh.read()


def test_fields_dump_byte_equal(pair, tmp_path):
    sj, st, a, b = pair
    ra = _bytes(DJ.dump_fields(sj, a, str(tmp_path / "fj")))
    names = DT.dump_fields(st, b, str(tmp_path / "ft"))
    assert names == [str(tmp_path / "ft") + ".0.0"]
    assert _bytes(names) == ra
    hdr, fields = RD.read_fields(names[0])
    assert hdr["step"] == 0 and hdr["nx"] == st.grid.nx
    np.testing.assert_array_equal(fields["ey"], np_(b.fields.ey))
    assert not fields["cmat"].any()


def test_fields_dump_material_ids_byte_equal(tmp_path):
    sj, st = shapes_jax.build(), shapes_torch.build(device="cpu")
    a = sj.initialize()
    b = to_torch(a)
    names = DT.dump_fields(st, b, str(tmp_path / "ft"), ftag=7)
    assert _bytes(names) == _bytes(DJ.dump_fields(sj, a,
                                                  str(tmp_path / "fj"),
                                                  ftag=7))
    _, fields = RD.read_fields(names[0])
    for k in DT.MAT_ID_ORDER:
        np.testing.assert_array_equal(fields[k], st._mat_ids[k])
    assert set(np.unique(fields["cmat"])) == {0, 1, 2}


def test_hydro_dump(pair, tmp_path):
    sj, st, a, b = pair
    for name in ("electron", "ion"):
        ra = _bytes(DJ.dump_hydro(sj, a, name, str(tmp_path / "hj")))
        names = DT.dump_hydro(st, b, name, str(tmp_path / "ht"))
        rb = _bytes(names)
        assert len(rb) == len(ra) and rb[:HDR + 20] == ra[:HDR + 20]
        ha = np.frombuffer(ra[HDR + 20:], "<f4").reshape(-1, 16)
        hb = np.frombuffer(rb[HDR + 20:], "<f4").reshape(-1, 16)
        assert np.abs(ha - hb).max() <= 1e-5 * np.abs(ha).max()
        hdr, hyd = RD.read_hydro(names[0])
        assert hdr["sp_id"] == st.species[[s.params.name for s in
                                           st.species].index(name)].params.id
        np.testing.assert_array_equal(hyd["rho"].reshape(-1), hb[:, 3])


def test_particle_dump(pair, tmp_path):
    sj, st, a, b = pair
    ra = _bytes(DJ.dump_particles(sj, a, "electron", str(tmp_path / "pj")))
    names = DT.dump_particles(st, b, "electron", str(tmp_path / "pt"))
    rb = _bytes(names)
    assert len(rb) == len(ra) and rb[:HDR + 12] == ra[:HDR + 12]
    dt = [("dx", "<f4"), ("dy", "<f4"), ("dz", "<f4"), ("i", "<i4"),
          ("ux", "<f4"), ("uy", "<f4"), ("uz", "<f4"), ("w", "<f4")]
    pa = np.frombuffer(ra[HDR + 12:], dt)
    pb = np.frombuffer(rb[HDR + 12:], dt)
    for n in ("dx", "dy", "dz", "i", "w"):
        assert np.array_equal(pa[n], pb[n]), n
    for n in ("ux", "uy", "uz"):
        assert np.abs(pa[n] - pb[n]).max() <= \
            5e-7 + 1e-5 * np.abs(pa[n]).max(), n
    hdr, parts = RD.read_particles(names[0])
    assert len(parts) == int(b.species[0].np) == len(pa)


def test_grid_materials_species_dumps_byte_equal(pair, tmp_path):
    sj, st, _, _ = pair
    assert _bytes(DT.dump_grid(st, str(tmp_path / "gt"))) == \
        _bytes(DJ.dump_grid(sj, str(tmp_path / "gj")))
    for fn in ("dump_materials", "dump_species"):
        getattr(DJ, fn)(sj, str(tmp_path / "j"))
        getattr(DT, fn)(st, str(tmp_path / "t"))
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()


def test_energies_file(pair, tmp_path):
    sj, st, a, b = pair
    fj, ft = str(tmp_path / "ej"), str(tmp_path / "et")
    for append in (False, True):
        DJ.dump_energies(sj, a, fj, append=append)
        DT.dump_energies(st, b, ft, append=append)
    lj, lt = open(fj).read().splitlines(), open(ft).read().splitlines()
    assert len(lt) == 5 and lt[:3] == lj[:3]
    for x, y in zip(lj[3:], lt[3:]):
        vx, vy = np.array(x.split(), float), np.array(y.split(), float)
        assert vx[0] == vy[0] == 0
        assert np.abs(vx - vy).max() <= 1e-6 * vx[1:].sum()
    en = [1.5, 2.25e-3, 0.0]
    assert DT.energies_line(12, en) == "12 1.500000e+00 2.250000e-03 " \
        "0.000000e+00\n"


def test_strided_dumps(pair, tmp_path):
    sj, st, a, b = pair
    kw = dict(stride=(2, 2, 1), components=["ex", "cbz", "rhof"])
    ra = _bytes(DJ.dump_fields_strided(sj, a, str(tmp_path / "fj"), **kw))
    rb = _bytes(DT.dump_fields_strided(st, b, str(tmp_path / "ft"), **kw))
    assert ra == rb
    gj = open(str(tmp_path / "fj") + ".0.global").read()
    gt = open(str(tmp_path / "ft") + ".0.global").read()
    assert gt == gj.replace(str(tmp_path / "fj"), str(tmp_path / "ft"))
    body = np.frombuffer(rb[HDR + 20:], "<f4").reshape(3, 1, 4, 4)
    np.testing.assert_array_equal(body[2], np_(b.fields.rhof)[1:2, 1:9:2,
                                                              1:9:2])
    with pytest.raises(ValueError):
        DT.dump_fields_strided(st, b, str(tmp_path / "x"), components=["q"])

    ra = _bytes(DJ.dump_hydro_strided(sj, a, "ion", str(tmp_path / "hj"),
                                      stride=(2, 1, 1)))
    rb = _bytes(DT.dump_hydro_strided(st, b, "ion", str(tmp_path / "ht"),
                                      stride=(2, 1, 1)))
    assert len(ra) == len(rb) and ra[:HDR + 20] == rb[:HDR + 20]
    ha, hb = (np.frombuffer(r[HDR + 20:], "<f4") for r in (ra, rb))
    assert np.abs(ha - hb).max() <= 1e-5 * np.abs(ha).max()
    gj = open(str(tmp_path / "hj") + ".0.global").read()
    gt = open(str(tmp_path / "ht") + ".0.global").read()
    assert gt == gj.replace(str(tmp_path / "hj"), str(tmp_path / "ht"))
    assert HT.N_HYDRO == 14


def test_native_writer(tmp_path):
    data = os.urandom(1 << 16)
    p = str(tmp_path / "blob")
    NIO.write_file(p, data)
    assert open(p, "rb").read() == data
    w = NIO.AsyncWriter(str(tmp_path / "blob2"))
    for _ in range(8):
        w.write(data)
    w.close()
    assert os.path.getsize(tmp_path / "blob2") == 8 * len(data)
    lib = NIO.library_path()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert struct.calcsize(RD.HEADER_FMT) == HDR
