"""The port's event detection (``repro_torch.core.events``) against the
JAX reference, on the cases of ``tests/test_events.py``.

Each case runs through both packages on the same inputs: ``found``,
``which`` and the accepted ``steps`` are held equal, the event time and
state within 1e-9 of the reference (the bisection halves the step 40
times; both packages' ERK steps agree to rounding), and each case keeps
the reference test's own check against the exact root.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import butcher as rbut
from repro.core import events as revents
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch.core import butcher, events, loops
from repro_torch.core.arkode import ODEOptions


def _t(v):
    return torch.tensor(v, dtype=torch.float64)


CASES = {
    # name: (reference f, g, port f, g, y0, tf, table, rtol, atol, root)
    "decay_threshold": (lambda t, y: -y, lambda t, y: y[0] - 0.5,
                        lambda t, y: -y, lambda t, y: y[0] - 0.5,
                        [1.0], 5.0, "DORMAND_PRINCE", 1e-8, 1e-12,
                        np.log(2.0)),
    "oscillator_zero": (lambda t, y: jnp.stack([y[1], -y[0]]),
                        lambda t, y: y[0],
                        lambda t, y: torch.stack([y[1], -y[0]]),
                        lambda t, y: y[0],
                        [1.0, 0.0], 10.0, "DORMAND_PRINCE", 1e-9, 1e-12,
                        np.pi / 2),
    "first_of_two": (lambda t, y: jnp.ones_like(y),
                     lambda t, y: jnp.stack([y[0] - 3.0, y[0] - 1.0]),
                     lambda t, y: torch.ones_like(y),
                     lambda t, y: torch.stack([y[0] - 3.0, y[0] - 1.0]),
                     [0.0], 10.0, "BOGACKI_SHAMPINE", 1e-8, 1e-12, 1.0),
    "quarter": (lambda t, y: -y, lambda t, y: y[0] - 0.25,
                lambda t, y: -y, lambda t, y: y[0] - 0.25,
                [1.0], 5.0, "DORMAND_PRINCE", 1e-8, 1e-12, np.log(4.0)),
    "no_event": (lambda t, y: -y, lambda t, y: y[0] + 1.0,
                 lambda t, y: -y, lambda t, y: y[0] + 1.0,
                 [1.0], 2.0, "DORMAND_PRINCE", 1e-8, 1e-12, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_events_match_reference(name):
    rf, rg, pf, pg, y0, tf, tab, rtol, atol, root = CASES[name]
    ref = revents.erk_integrate_with_events(
        rf, rg, jnp.asarray(y0), 0.0, tf, getattr(rbut, tab),
        RefOptions(rtol=rtol, atol=atol))
    loops.reset_loop_counts()
    got = events.erk_integrate_with_events(
        pf, pg, _t(y0), 0.0, tf, getattr(butcher, tab),
        ODEOptions(rtol=rtol, atol=atol))
    assert bool(got.found) == bool(ref.found) == (root is not None)
    assert int(got.which) == int(ref.which)
    assert int(got.steps) == int(ref.steps)
    # one host read an attempt; a run without an event ends at tf
    assert loops.loop_counts["host_syncs"] >= int(got.steps)
    assert abs(float(got.t_event) - float(ref.t_event)) < 1e-9
    np.testing.assert_allclose(got.y_event.numpy(), np.asarray(ref.y_event),
                               rtol=0, atol=1e-9)
    if root is None:
        assert abs(float(got.t_event) - tf) < 1e-12
    else:
        assert abs(float(got.t_event) - root) < 1e-6
