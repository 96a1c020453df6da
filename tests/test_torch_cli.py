"""The port's deck runner (python -m vpic_tpu_torch, vpic_tpu_torch/
__main__.py) on the CPU: a tiny .py deck and the built-in weibel deck with
--energies and --checkpt, restarted with --restore from the middle
checkpoint: on the CPU (deterministic plain versions) the restart's
energies lines are the uninterrupted run's byte for byte; --quota,
--modify, --remap and an unknown deck."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from vpic_tpu_torch import __main__ as CLI
from vpic_tpu_torch import checkpoint as CK

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent

DECK = textwrap.dedent('''
    import numpy as np
    import vpic_tpu_torch as vt


    def build(argv):
        nppc = int(argv[argv.index("--nppc") + 1]) if "--nppc" in argv else 2
        sim = vt.Simulation(seed=4, device="cuda")
        sim.define_units(1.0, 1.0)
        sim.define_timestep(0.05)
        sim.define_periodic_grid((0, 0, 0), (1.0, 0.5, 0.1), (12, 6, 1))
        sim.define_material("vacuum", 1.0)
        sim.define_field_array(damp=0.0)
        sim.status_interval = 4
        sim.num_step = 8
        e = sim.define_species("e", -1.0, 1.0, 12 * 6 * nppc * 2)
        rng = np.random.default_rng(1)
        for _ in range(12 * 6 * nppc):
            sim.inject_particle(e, rng.uniform(0, 1.0), rng.uniform(0, 0.5),
                                0.05, *rng.normal(0, 0.2, 3), 0.01)
        sim.set_region_field(vt.everywhere,
                             ey=lambda x, y, z: 0.1 * np.sin(2 * np.pi * x))
        return sim
''')


def _lines(path):
    return Path(path).read_text().splitlines()


def test_py_deck_restart_matches(tmp_path):
    deck = tmp_path / "deck.py"
    deck.write_text(DECK)
    e1, e2 = tmp_path / "E1", tmp_path / "E2"
    base = str(tmp_path / "ck")
    sim, state = CLI.main([str(deck), "--device", "cpu", "--nppc", "3",
                           "--num-step", "12", "--energies", str(e1),
                           "--checkpt", f"{base}:4"])
    assert sim.device.type == "cpu" and state.step == 12
    assert sim.species[0].count == 12 * 6 * 3
    assert [Path(f"{base}.{k}.npz").exists() for k in (4, 8, 12)] == \
        [True] * 3
    lines = _lines(e1)
    assert lines[0] == "%% Layout" and [ln.split()[0] for ln in lines[3:]] \
        == ["0", "4", "8", "12"]
    sim2, state2 = CLI.main([str(deck), "--device", "cpu", "--nppc", "3",
                             "--num-step", "12", "--restore", f"{base}.4",
                             "--energies", str(e2)])
    assert _lines(e2)[3:] == lines[4:]
    assert CK.checksum(state2) == CK.checksum(state)


def test_weibel_restart_matches(tmp_path):
    mod = tmp_path / "mod"
    mod.write_text("status_interval 5\n")
    e1, e2 = tmp_path / "E1", tmp_path / "E2"
    base = str(tmp_path / "ck")
    common = ["weibel", "--device", "cpu", "--num-step", "20", "--modify",
              str(mod)]
    _, state = CLI.main(common + ["--energies", str(e1),
                                 "--checkpt", f"{base}:10"])
    _, state2 = CLI.main(common + ["--restore", f"{base}.10",
                                   "--energies", str(e2)])
    lines = _lines(e1)
    assert [ln.split()[0] for ln in lines[3:]] == ["0", "5", "10", "15", "20"]
    assert _lines(e2)[3:] == lines[5:]
    assert state2.step == state.step == 20
    assert CK.checksum(state2) == CK.checksum(state)


def test_quota_checkpoints_and_stops(tmp_path):
    deck = tmp_path / "deck.py"
    deck.write_text(DECK)
    base = str(tmp_path / "ck")
    _, state = CLI.main([str(deck), "--device", "cpu", "--quota", "0",
                         "--checkpt", base])
    # run() checks the quota after each chunk, the deck's status_interval
    # (4) steps, as vpic_tpu's does
    assert state.step == 4
    data = np.load(f"{base}.quota.npz")
    assert int(data["step"]) == 4


def test_remap_and_unknown_deck(tmp_path):
    """--remap needs --restore and a checkpoint to read (remapping itself:
    tests/test_torch_sharded_io.py); an unknown deck is refused."""
    with pytest.raises(SystemExit):
        CLI.main(["weibel", "--device", "cpu", "--remap"])
    with pytest.raises(FileNotFoundError):
        CLI.main(["weibel", "--device", "cpu", "--restore",
                  str(tmp_path / "x"), "--remap"])
    with pytest.raises(SystemExit):
        CLI.main(["no_such_deck", "--device", "cpu"])


def test_module_entry_point(tmp_path):
    """python -m vpic_tpu_torch runs a deck on the CPU."""
    deck = tmp_path / "deck.py"
    deck.write_text(DECK)
    out = subprocess.run(
        [sys.executable, "-m", "vpic_tpu_torch", str(deck), "--device",
         "cpu", "--num-step", "4"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "Completed step 4 of 4" in out.stdout


# the nine decks ported after the runner: each runs by name at its defaults
NINE = ("twostream", "weibel_gold", "beam_plas", "force_free", "sc08",
        "asymm4sp", "dipole", "waveguide", "cygnus")


@pytest.mark.parametrize("deck", NINE)
def test_built_in_deck_runs(deck):
    """python -m vpic_tpu_torch DECK --num-step 2 on the CPU, in process:
    the port's module, two steps, finite energies, every staged particle
    kept (none of these decks loses one in two steps)."""
    assert CLI.load_deck(deck).__name__ == f"vpic_tpu_torch.models.{deck}"
    sim, state = CLI.main([deck, "--device", "cpu", "--num-step", "2"])
    assert sim.device.type == "cpu" and state.step == 2
    assert torch.isfinite(sim.energies(state)).all()
    assert [int(sp.np) for sp in state.species] == \
        [st.count for st in sim.species]
