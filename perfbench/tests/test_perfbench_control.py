"""The precision control at a size a test run holds: the reference in
bfloat16, put in the program's place, fails the cell's own limits; the
program itself passes them (``calibrate.py`` reads the same on the card at
the cell's size)."""
import pytest
import torch

from perfbench import calibrate
from perfbench.harness import cell as cell_mod
from perfbench.harness import train
from perfbench.tests import tiny


@pytest.mark.parametrize("config", ["danet-bilstm", "multichip-dp4"])
def test_training_control(config, monkeypatch):
    c = tiny.cell("danet-bilstm.train", monkeypatch, config=config)
    loop, first = train.start(c, "cpu")
    loop.close()
    got = calibrate.train_readings(c, first, loop.traffic, "cpu", world=2)
    lim = c.limits
    assert cell_mod.judge({k: (v, lim[k])
                           for k, v in got["program"].items()})
    for fault in ("control", "half", "no_exchange"):
        assert not cell_mod.judge({k: (v, lim[k])
                                   for k, v in got[fault].items()}), fault


def test_serving_control(monkeypatch):
    c = tiny.cell("danet-bilstm.serve", monkeypatch)
    got = calibrate.serve_readings(c, "cpu")
    lim = c.limits["wave_gap"]
    assert got["program"]["wave_gap"] <= lim
    assert got["control"]["wave_gap"] > lim
    assert got["half"]["wave_gap"] > lim
    assert torch.get_default_dtype() == torch.float32
