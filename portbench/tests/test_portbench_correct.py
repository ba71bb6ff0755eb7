"""``correct`` holds the window's answers to the plain reference: a sound
run passes, and each fault a cell can have, planted under a run that
goes on as the benchmark's does, and the lower-precision control fail.

The faults are applied to each call's answer as it comes out of
``integrate``: a call that returns its state unchanged (the solve's
start, or the output before), half of the systems left at it, and an
answer altered (one component of every fourth system moved by a
relative 1e-2, a hundred times the relative tolerance asked for).  The
cells run on one card, so no exchange between cards can be left out.
The CPU runs take a few dozen systems through the port's plain
versions; the card's test takes the control at 2^16."""
import pytest

torch = pytest.importorskip("torch")

from conftest import CELLS, run_cell  # noqa: E402


def unchanged(call, y_in, y):
    return y_in.clone()


def half_left_out(call, y_in, y):
    keep = (torch.arange(y.shape[0], device=y.device) % 2 == 0)[:, None]
    return torch.where(keep, y_in, y)


def answer_altered(call, y_in, y):
    y = y.clone()
    y[::4, 0] *= 1.0 + 1e-2
    return y


FAULTS = {"unchanged": unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(man, cell):
    run, values, correct = run_cell(man, cell, seconds=1.0)
    assert values["calls_failed"] == 0
    assert correct, values


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(man, cell, fault):
    run, values, correct = run_cell(man, cell, seconds=1.0,
                                    fault=FAULTS[fault])
    assert not correct, values


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(man, cell):
    run, values, correct = run_cell(man, cell, dtype=torch.float32,
                                    seconds=1.0)
    assert run.dtype == torch.float32
    assert not correct, values


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_the_program_passes_and_the_control_fails(man, card,
                                                              cell):
    _, values, correct = run_cell(man, cell, nsys=2 ** 16, device="cuda",
                                  seconds=2.0)
    assert correct, values
    _, values, correct = run_cell(man, cell, nsys=2 ** 16, device="cuda",
                                  seconds=2.0, dtype=torch.float32)
    assert not correct, values
