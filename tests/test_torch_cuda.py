"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test decides inside itself whether a GPU is
present and skips without one.  This file imports no JAX, so with the
JAX-importing ``tests/conftest.py`` left out it runs on a machine that
has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.kernels import block_solve, blockdiag_spmv, newton

NBS = [7, 130, 516]
#: |kernel - plain| <= TOL * max(1, max|plain|)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _inputs(nb, dtype):
    rng = np.random.default_rng(nb)
    d = {"z": rng.normal(size=(3, nb)), "f": rng.normal(size=(3, nb)),
         "psi": rng.normal(size=(3, nb)), "gam": np.abs(rng.normal(size=nb)),
         "w": np.abs(rng.normal(size=(3, nb))) + 0.1,
         "mask": rng.uniform(size=nb) > 0.4,
         "W": rng.normal(size=(6, 6, nb)), "Z": rng.normal(size=(6, 3, nb))}
    for b in (3, 8, 9, 16, 32):
        d[f"A{b}"] = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
        d[f"r{b}"] = rng.normal(size=(b, nb))
    out = {k: torch.from_numpy(v).to("cuda") for k, v in d.items()}
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in out.items()}


def _gj(b):
    return "" if b <= 8 else "_tiled"


#: case -> (wrapper, plain version, input keys, registry name)
CASES = {
    "newton_residual": (newton.newton_residual, newton.newton_residual_plain,
                        ("z", "f", "psi", "gam"), "newton_residual"),
    "masked_update_wrms": (newton.masked_update_wrms,
                           newton.masked_update_wrms_plain,
                           ("z", "f", "w", "mask"), "masked_update_wrms"),
    "history_rescale": (newton.history_rescale, newton.history_rescale_plain,
                        ("W", "Z", "mask"), "history_rescale"),
    "wrms_soa": (newton.wrms_soa, newton.wrms_soa_plain, ("z", "w"),
                 "wrms_soa"),
    "blockdiag_spmv": (blockdiag_spmv.blockdiag_spmv_soa,
                       blockdiag_spmv.blockdiag_spmv_soa_plain, ("A3", "z"),
                       "blockdiag_spmv"),
    **{f"block_inverse_b{b}": (block_solve.block_inverse_soa,
                               block_solve.block_inverse_soa_plain,
                               (f"A{b}",), "block_inverse" + _gj(b))
       for b in (3, 8, 16)},
    **{f"block_solve_b{b}": (block_solve.block_solve_soa,
                             block_solve.block_solve_soa_plain,
                             (f"A{b}", f"r{b}"), "block_solve" + _gj(b))
       for b in (3, 8, 9, 16, 32)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_card(case, nb, dtype):
    _need_card()
    kern, plain, keys, name = CASES[case]
    d = _inputs(nb, dtype)
    args = [d[k] for k in keys]
    kernels.reset_counts()
    got = kern(*args)
    assert kernels.counts()[name] == (1, 0)
    want = plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= TOL[dtype] * scale
    if case == "history_rescale":
        off = ~d["mask"]
        assert torch.equal(got[0][:, :, off], d["Z"][:, :, off])


@pytest.mark.cuda
def test_wrapper_rejects_bad_inputs_on_card():
    _need_card()
    d = _inputs(130, torch.float64)
    with pytest.raises(ValueError, match="not contiguous"):
        newton.wrms_soa(d["z"].T.contiguous().T, d["w"])
    with pytest.raises(TypeError, match="dtype"):
        newton.masked_update_wrms(d["z"], d["f"], d["w"], d["z"][0])
    with pytest.raises(ValueError, match="lies on cpu"):
        blockdiag_spmv.blockdiag_spmv_soa(d["A3"], d["z"].cpu())
