"""CV_*-style integer return codes, carried per lane in data.

The values are those of ``repro.core.status`` (which follows CVODE's
``cvode.h`` flags); a test checks that the two tables agree.  A lane
whose retcode goes nonzero is quarantined: it drops out of the step
loop's ``active`` mask and keeps its last accepted state.
"""
from __future__ import annotations

SUCCESS = 0
TOO_MUCH_WORK = -1
ERR_FAILURE = -3
CONV_FAILURE = -4
RHSFUNC_FAIL = -8

#: consecutive Newton convergence failures before quarantine (CVODE MXNCF)
MXNCF = 10
#: consecutive local-error-test failures before quarantine (CVODE uses 7;
#: doubled because the cold start calibrates h with a few failures)
MXNEF = 15

RETCODE_NAMES = {
    SUCCESS: "SUCCESS",
    TOO_MUCH_WORK: "TOO_MUCH_WORK",
    ERR_FAILURE: "ERR_FAILURE",
    CONV_FAILURE: "CONV_FAILURE",
    RHSFUNC_FAIL: "RHSFUNC_FAIL",
}


def retcode_name(code: int) -> str:
    """Symbolic name for ``code`` (``"UNKNOWN(<n>)"`` off the table)."""
    return RETCODE_NAMES.get(int(code), f"UNKNOWN({int(code)})")
