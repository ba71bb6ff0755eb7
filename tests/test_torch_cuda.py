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
from repro_torch.kernels import (block_solve, blockdiag_spmv, newton, sparse,
                                 vecops)

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


# ---------------------------------------------------------------------------
# The sparse ensemble's kernels: bsr_spmv_soa, linear_combination, dot
# ---------------------------------------------------------------------------


def _brusselator_pattern(nx):
    """The 1x1 block pattern of the ensemble Brusselator's Jacobian
    (n = 2*nx, 124 entries at nx = 16), diagonal included."""
    n = 2 * nx
    P = np.zeros((n, n), bool)
    for i in range(nx):
        P[2 * i:2 * i + 2, 2 * i:2 * i + 2] = True
        for j in (i - 1, i + 1):
            if 0 <= j < nx:
                P[2 * i, 2 * j] = P[2 * i + 1, 2 * j + 1] = True
    rows, cols = np.nonzero(P)
    return tuple(int(r) for r in rows), tuple(int(c) for c in cols), n


#: a block pattern out of row order, with a repeated block and an empty
#: block row (row 2)
SCRAMBLED = ((3, 0, 1, 0, 3, 1, 0), (0, 1, 1, 0, 3, 1, 3), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", NBS + [1 << 16])
@pytest.mark.parametrize("b", [1, 2, 3, 9])
@pytest.mark.parametrize("which", ["brusselator", "scrambled"])
def test_bsr_spmv_matches_plain_on_card(which, b, nb):
    _need_card()
    pattern = _brusselator_pattern(16) if which == "brusselator" \
        else SCRAMBLED
    rng = np.random.default_rng(b * nb)
    values = torch.from_numpy(rng.normal(size=(len(pattern[0]), b, b, nb)))
    x = torch.from_numpy(rng.normal(size=(pattern[2], b, nb)))
    values, x = values.cuda(), x.cuda()
    kernels.reset_counts()
    got = sparse.bsr_spmv_soa(values, x, pattern)
    assert kernels.counts()["bsr_spmv"] == (1, 0)
    want = sparse.bsr_spmv_soa_plain(values, x, pattern)
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-10 * scale
    if which == "scrambled":
        assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 8193, 1 << 21])
@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
def test_linear_combination_matches_plain_on_card(K, n):
    _need_card()
    rng = np.random.default_rng(K * n)
    xs = [torch.from_numpy(rng.normal(size=n)).cuda() for _ in range(K)]
    # device scalars, a (K,) tensor and Python numbers all reach it
    coeffs = torch.from_numpy(rng.normal(size=K)).cuda()
    for form in (coeffs, [c for c in coeffs], coeffs.tolist()):
        kernels.reset_counts()
        got = vecops.linear_combination(form, xs)
        assert kernels.counts()["linear_combination"] == (1, 0)
        want = vecops.linear_combination_plain(form, xs)
        torch.cuda.synchronize()
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-10 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 1000, 8193, 1 << 21])
def test_dot_matches_plain_and_repeats_its_bits_on_card(n, dtype):
    _need_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.normal(size=n)).to("cuda", dtype)
    y = torch.from_numpy(rng.normal(size=n)).to("cuda", dtype)
    kernels.reset_counts()
    got = vecops.dot(x, y)
    assert kernels.counts()["dot"] == (1, 0)
    assert got.shape == () and got.device.type == "cuda"
    want = vecops.dot_plain(x.double(), y.double())
    scale = (x.double() * y.double()).abs().sum().item()
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert abs(got.item() - want.item()) <= tol * scale
    # deterministic: the same input gives the same bits
    assert torch.equal(vecops.dot(x, y), got)
