"""The window's arithmetic: ``systems_per_s`` counts whole calls over the
whole time from the first call's start to the last one's end, so a stall
anywhere in the window lowers it."""
import time
import types

import pytest

from conftest import run_cell
from portbench.harness import traffic

CELL = "rober3-bdf.solve-2m"


def _reader(man, name):
    return man.reader(name).read


def test_the_rate_is_whole_solves_over_the_window(man):
    rate = _reader(man, "systems_per_s")
    run = types.SimpleNamespace(nsys=1000, solves=10, window_s=4.0)
    assert rate(run) == pytest.approx(2500.0)
    assert rate(types.SimpleNamespace(nsys=1000, solves=0, window_s=0.0)) \
        is None


def test_a_planted_stall_lowers_the_rate(man):
    stall = 1.0

    def slow(call, y_in, y):
        if call.index == 1:
            time.sleep(stall)
        return y

    rate = _reader(man, "systems_per_s")
    clean, _, ok = run_cell(man, CELL, nsys=16, seconds=0.01)
    assert ok and clean.solves == 1
    calls = clean.calls
    # the window runs whole solves until one ends past ``seconds``
    stalled, _, ok = run_cell(man, CELL, nsys=16, seconds=0.01, fault=slow)
    assert ok and stalled.solves == 1 and stalled.calls == calls
    # the stall lies between two calls, inside the window
    assert stalled.window_s >= sum(stalled.call_s) + stall
    assert rate(stalled) == pytest.approx(stalled.nsys / stalled.window_s)
    assert rate(stalled) <= stalled.nsys / (sum(stalled.call_s) + stall)
    assert rate(stalled) < rate(clean)


def test_a_solve_is_one_call_an_output_time():
    cfg = {"t0": 0.0, "t1": 0.4, "tmult": 10.0, "nout": 3}
    calls = [c for _, c in zip(range(4), traffic.calls(cfg))]
    assert [(c.seq, c.t0, c.t1, c.cold, c.last) for c in calls] == [
        (0, 0.0, 0.4, True, False), (0, 0.4, 4.0, False, False),
        (0, 4.0, pytest.approx(40.0), False, True),
        (1, 0.0, 0.4, True, False)]
    with pytest.raises(ValueError):
        traffic.outputs({"t0": 1.0, "t1": 0.5, "tmult": 10.0, "nout": 2})
