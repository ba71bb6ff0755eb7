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
from repro_torch.apps.brusselator import jacobian_csr_pattern
from repro_torch.core import dispatch as dv
from repro_torch.core.sunmatrix import CSRPattern
from repro_torch.kernels import (block_solve, blockdiag_spmv, newton, sparse,
                                 vecops)

NBS = [7, 130, 516]
#: the Newton iteration's and lsetup's fused kernels (b <= 8) are also
#: checked at the main path's batch
FUSED_NBS = NBS + [1 << 20]
#: block sizes of the Gauss-Jordan and SpMV cases: the register bodies
#: (b <= 8), the warp forms (9 <= b <= 32: its edges, the SpMV's
#: templated 16 and 24, and path B's and K's 32) and the forms above (33)
GJ_BS = (3, 8, 9, 16, 24, 32, 33)
#: |kernel - plain| <= TOL * max(1, max|plain|)
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
#: bodies that sum in their plain version's order, each product and sum
#: rounded alone: equal to it bit for bit
EXACT = ("blockdiag_spmv", "history_rescale", "lagrange_rescale",
         "newton_residual_lsolve")
#: block sizes of the fused Newton residual and lsolve (b <= 8)
LSOLVE_BS = range(1, 9)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _eta_q(nb, rng):
    """Step ratios over [0.1, 10] (every fifth exactly 1) and valid
    history counts q over 0..5 (int32), each q at least once when nb >=
    6: the fused rebuild's inputs."""
    eta = 10.0 ** rng.uniform(-1, 1, size=nb)
    eta[::5] = 1.0
    return eta, rng.permutation(np.arange(nb) % 6).astype(np.int32)


def _inputs(nb, dtype):
    rng = np.random.default_rng(nb)
    d = {"z": rng.normal(size=(3, nb)), "f": rng.normal(size=(3, nb)),
         "psi": rng.normal(size=(3, nb)), "gam": np.abs(rng.normal(size=nb)),
         "w": np.abs(rng.normal(size=(3, nb))) + 0.1,
         "mask": rng.uniform(size=nb) > 0.4,
         "W": rng.normal(size=(6, 6, nb)), "Z": rng.normal(size=(6, 3, nb))}
    d["eta"], d["q"] = _eta_q(nb, rng)
    d["gamrat"] = rng.uniform(0.7, 1.3, size=nb)
    for b in LSOLVE_BS:
        for k in ("z", "f", "psi"):
            d[f"{k}{b}"] = rng.normal(size=(b, nb))
        M = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
        d[f"Minv{b}"] = np.linalg.inv(M.transpose(2, 0, 1)) \
            .transpose(1, 2, 0).copy()
    for b in GJ_BS:
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
    "lagrange_rescale": (newton.lagrange_rescale,
                         newton.lagrange_rescale_plain,
                         ("eta", "q", "Z", "mask"), "lagrange_rescale"),
    "wrms_soa": (newton.wrms_soa, newton.wrms_soa_plain, ("z", "w"),
                 "wrms_soa"),
    **{f"newton_residual_lsolve_b{b}": (
        newton.newton_residual_lsolve, newton.newton_residual_lsolve_plain,
        (f"z{b}", f"f{b}", f"psi{b}", "gam", "gamrat", f"Minv{b}"),
        "newton_residual_lsolve") for b in LSOLVE_BS},
    **{f"blockdiag_spmv_b{b}": (blockdiag_spmv.blockdiag_spmv_soa,
                                blockdiag_spmv.blockdiag_spmv_soa_plain,
                                (f"A{b}", f"r{b}"), "blockdiag_spmv")
       for b in GJ_BS},
    **{f"block_inverse_b{b}": (block_solve.block_inverse_soa,
                               block_solve.block_inverse_soa_plain,
                               (f"A{b}",), "block_inverse" + _gj(b))
       for b in GJ_BS},
    **{f"block_solve_b{b}": (block_solve.block_solve_soa,
                             block_solve.block_solve_soa_plain,
                             (f"A{b}", f"r{b}"), "block_solve" + _gj(b))
       for b in GJ_BS},
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
        if name in EXACT:
            assert torch.equal(g, w)
            continue
        scale = max(1.0, w.abs().max().item())
        assert (g - w).abs().max().item() <= TOL[dtype] * scale
    if case in ("history_rescale", "lagrange_rescale"):
        off = ~d["mask"]
        assert torch.equal(got[0][:, :, off], d["Z"][:, :, off])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("b", LSOLVE_BS)
def test_newton_residual_lsolve_bit_for_bit_at_the_main_paths_batch_on_card(
        b, dtype):
    """The fused Newton iteration over 2**20 systems (the main path's
    batch) equals its plain version, and the composition of the row 1
    and row 2 kernels with the plain correction, bit for bit."""
    _need_card()
    nb = 1 << 20
    gen = torch.Generator(device="cuda").manual_seed(b)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    z, f, psi = rnd(b, nb), rnd(b, nb), rnd(b, nb)
    gam, gamrat = rnd(nb).abs(), 0.7 + 0.6 * rnd(nb).abs().clamp(max=1)
    Minv = rnd(b, b, nb) / b + torch.eye(b, device="cuda",
                                         dtype=dtype)[:, :, None]
    kernels.reset_counts()
    got = newton.newton_residual_lsolve(z, f, psi, gam, gamrat, Minv)
    assert kernels.counts()["newton_residual_lsolve"] == (1, 0)
    assert torch.equal(got, newton.newton_residual_lsolve_plain(
        z, f, psi, gam, gamrat, Minv))
    two = (2.0 / (1.0 + gamrat))[None, :] * blockdiag_spmv.blockdiag_spmv_soa(
        Minv, newton.newton_residual(z, f, psi, gam, negate=True))
    assert torch.equal(got, two)


def _same_bits(got, want):
    """Equal values, NaN where NaN (what ``torch.equal`` says of finite
    tensors)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def _nonfinite_systems(t):
    """Systems (the last axis) with a non-finite entry."""
    return (~t.isfinite()).reshape(-1, t.shape[-1]).any(dim=0)


def _newton_update_inputs(b, nb, dtype):
    """The fused Newton iteration's inputs over nb systems (random mask),
    with non-finite systems planted where nb allows: a NaN in z, an inf
    in f, a NaN in Minv, an inf gamma."""
    gen = torch.Generator(device="cuda").manual_seed(1000 * b + nb % 1000)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    z, f, psi, w = rnd(b, nb), rnd(b, nb), rnd(b, nb), rnd(b, nb).abs() + 0.1
    gam, gamrat = rnd(nb).abs(), 0.7 + 0.6 * rnd(nb).abs().clamp(max=1)
    Minv = rnd(b, b, nb) / b + torch.eye(b, device="cuda",
                                         dtype=dtype)[:, :, None]
    mask = torch.rand(nb, generator=gen, device="cuda") > 0.4
    if nb >= 7:
        z[0, 1] = float("nan")
        f[b - 1, 3] = float("inf")
        Minv[b - 1, 0, 4] = float("nan")
        gam[5] = float("inf")
    return z, f, psi, gam, gamrat, Minv, w, mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", FUSED_NBS)
@pytest.mark.parametrize("b", LSOLVE_BS)
def test_newton_update_bit_for_bit_on_card(b, nb, dtype):
    """Row 1+2+3f, one launch: z' equals its plain version's bit for bit
    and both outputs equal rows 1+2f and 3's (the launches it replaces)
    bit for bit, planted non-finite systems included; the norm is held
    to the plain version's as row 3's is (PyTorch's mean sums in its own
    order and multiplies by 1/b)."""
    _need_card()
    args = _newton_update_inputs(b, nb, dtype)
    kernels.reset_counts()
    z_new, dn = newton.newton_update(*args)
    assert kernels.counts()["newton_update"] == (1, 0)
    z_two, dn_two = newton.masked_update_wrms(
        args[0], newton.newton_residual_lsolve(*args[:6]), *args[6:])
    z_plain, dn_plain = newton.newton_update_plain(*args)
    torch.cuda.synchronize()
    _same_bits(z_new, z_two)
    _same_bits(dn, dn_two)
    _same_bits(z_new, z_plain)
    assert torch.equal(dn.isnan(), dn_plain.isnan())
    fin = dn_plain.isfinite()
    scale = max(1.0, dn_plain[fin].abs().max().item())
    assert (dn[fin] - dn_plain[fin]).abs().max().item() <= TOL[dtype] * scale
    if nb >= 7:
        assert torch.equal(_nonfinite_systems(z_new) | ~dn.isfinite(),
                           _nonfinite_systems(z_plain) | ~dn_plain.isfinite())
        assert bool(~dn[[1, 3, 4, 5]].isfinite().all())


def _newton_jacobian_inputs(b, nb, dtype):
    """Jacobians J (b, b, nb) whose Newton blocks I - gamma*J are
    diagonally dominant, gamma (nb,), with a zero column in every fourth
    system and, where nb allows, non-finite and singular systems planted:
    a NaN entry, an inf entry, an inf gamma, a block whose row 0 is zero
    (gamma 1, J's row 0 the unit row) and one whose last pivot is zero."""
    gen = torch.Generator(device="cuda").manual_seed(2000 * b + nb % 1000)
    gam = torch.rand(nb, generator=gen, device="cuda", dtype=dtype) + 0.01
    J = torch.randn(b, b, nb, generator=gen, device="cuda", dtype=dtype) \
        / (b * (gam + 1.0))
    J[:, -1, ::4] = 0.0
    if nb >= 7:
        J[b - 1, 0, 1] = float("nan")
        J[0, b - 1, 2] = float("inf")
        gam[3] = float("inf")
        gam[4] = 1.0
        J[0, :, 4] = 0.0
        J[0, 0, 4] = 1.0
        gam[5] = 1.0
        J[:, :, 5] = torch.eye(b, device="cuda", dtype=dtype)
    return J, gam


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", FUSED_NBS)
@pytest.mark.parametrize("b", LSOLVE_BS)
def test_newton_block_inverse_bit_for_bit_on_card(b, nb, dtype):
    """Row 6f, one launch: equal to its plain version and to row 6 on the
    plain Newton blocks bit for bit, with a non-finite output on exactly
    the systems where the plain version has one (the planted NaN, inf
    and singular blocks) and the plain version's bits on every other."""
    _need_card()
    from repro_torch.core.linsol import newton_blocks_soa
    J, gam = _newton_jacobian_inputs(b, nb, dtype)
    kernels.reset_counts()
    got = block_solve.newton_block_inverse_soa(J, gam)
    assert kernels.counts()["newton_block_inverse"] == (1, 0)
    plain = block_solve.newton_block_inverse_soa_plain(J, gam)
    row6 = block_solve.block_inverse_soa(newton_blocks_soa(J, gam))
    torch.cuda.synchronize()
    _same_bits(got, plain)
    _same_bits(got, row6)
    bad = _nonfinite_systems(plain)
    assert torch.equal(_nonfinite_systems(got), bad)
    assert torch.equal(got[:, :, ~bad], plain[:, :, ~bad])
    if nb >= 7:
        assert bool(bad[[1, 2, 3, 4, 5]].all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 8, 9, 32])
def test_newton_residual_bit_for_bit_on_card(n, dtype):
    """Row 1 equals its plain version bit for bit, both signs."""
    _need_card()
    rng = np.random.default_rng(n)
    z, f, psi = (torch.from_numpy(rng.normal(size=(n, 516))).to("cuda", dtype)
                 for _ in range(3))
    gam = torch.from_numpy(np.abs(rng.normal(size=516))).to("cuda", dtype)
    for negate in (False, True):
        got = newton.newton_residual(z, f, psi, gam, negate=negate)
        assert torch.equal(got, newton.newton_residual_plain(
            z, f, psi, gam, negate=negate))


#: state sizes of the rescale's two forms (n <= 4, the main path's 3;
#: n > 4 in chunks of two components: its first width, 12, paths B-F's
#: 32, and 33, whose last chunk holds one component), also the WRMS's
STATE_NS = (3, 5, 12, 32, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", NBS + [1 << 16])
@pytest.mark.parametrize("n", STATE_NS)
@pytest.mark.parametrize("mask", ["mixed", "none", "all"])
def test_history_rescale_entries_bit_for_bit_on_card(mask, n, nb, dtype):
    """Both rebuild entries, W read from memory (``history_rescale``) and
    W formed from (eta, q) (``lagrange_rescale``), equal their plain
    versions bit for bit, each one launch of its kernel: every q from 0
    to 5, eta = 1 lanes, inactive lanes copied bit-exactly; a mixed
    mask, no system active and every system active."""
    _need_card()
    rng = np.random.default_rng([n, nb])
    eta, q = _eta_q(nb, rng)
    active = {"mixed": rng.uniform(size=nb) > 0.4,
              "none": np.zeros(nb, bool), "all": np.ones(nb, bool)}[mask]
    W = rng.normal(size=(6, 6, nb))
    Z = rng.normal(size=(6, n, nb))
    eta, W, Z = (torch.from_numpy(a).to("cuda", dtype) for a in (eta, W, Z))
    q, active = torch.from_numpy(q).cuda(), torch.from_numpy(active).cuda()
    for name, kern, plain, args in (
            ("history_rescale", newton.history_rescale,
             newton.history_rescale_plain, (W, Z, active)),
            ("lagrange_rescale", newton.lagrange_rescale,
             newton.lagrange_rescale_plain, (eta, q, Z, active))):
        kernels.reset_counts()
        got = kern(*args)
        assert kernels.counts()[name] == (1, 0)
        want = plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        assert torch.equal(got[:, :, ~active], Z[:, :, ~active]), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("nb", NBS + [1 << 16])
@pytest.mark.parametrize("n", STATE_NS)
def test_wrms_soa_state_sizes_on_card(n, nb, dtype):
    """The per-system WRMS at the main path's n = 3 and paths B-F's
    n = 32 (and 5, 12, 33) against its plain version within TOL of
    max(1, |plain|): ``torch.mean`` may sum in another order."""
    _need_card()
    rng = np.random.default_rng([n, nb, 5])
    v = torch.from_numpy(rng.normal(size=(n, nb))).to("cuda", dtype)
    w = torch.from_numpy(np.abs(rng.normal(size=(n, nb))) + 0.1).to(
        "cuda", dtype)
    kernels.reset_counts()
    got = newton.wrms_soa(v, w)
    assert kernels.counts()["wrms_soa"] == (1, 0)
    want = newton.wrms_soa_plain(v, w)
    torch.cuda.synchronize()
    assert got.shape == (nb,)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL[dtype] * scale


@pytest.mark.cuda
def test_gauss_jordan_on_brusselator_newton_blocks_on_card():
    """Path B's Newton blocks, I - gamma*J at the Brusselator ensemble's
    initial states (2**16 systems, b = 32), gamma over 1e-4..1e-1: both
    tiled bodies agree with their plain versions and solve M x = r to
    |M x - r| <= 1e-10*(|M||x| + |r|)."""
    _need_card()
    from repro_torch.core import problems
    nb = 1 << 16
    y0 = problems.ensemble_brusselator(nb, nx=16, device="cuda")[3]
    jac = problems.ensemble_brusselator_soa(nb, nx=16, device="cuda")[1]
    J = jac(torch.zeros(nb, device="cuda", dtype=y0.dtype), y0.T.contiguous())
    rng = np.random.default_rng(16)
    gam = torch.from_numpy(10.0 ** rng.uniform(-4, -1, size=nb)).cuda()
    M = (torch.eye(32, device="cuda", dtype=J.dtype)[:, :, None]
         - gam * J).contiguous()
    r = torch.from_numpy(rng.normal(size=(32, nb))).cuda()
    kernels.reset_counts()
    inv = block_solve.block_inverse_soa(M)
    x = block_solve.block_solve_soa(M, r)
    assert kernels.counts()["block_inverse_tiled"] == (1, 0)
    assert kernels.counts()["block_solve_tiled"] == (1, 0)
    for got, want in ((inv, block_solve.block_inverse_soa_plain(M)),
                      (x, block_solve.block_solve_soa_plain(M, r))):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-10 * scale
    for sol in (x, torch.einsum("ijs,js->is", inv, r)):
        back = (torch.einsum("ijs,js->is", M, sol) - r).abs()
        scale = torch.einsum("ijs,js->is", M.abs(), sol.abs()) + r.abs()
        assert bool((back <= 1e-10 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("b", [9, 32, 33])
def test_gauss_jordan_singular_and_nan_blocks_on_card(b):
    """A zero block, a zero row, a zero pivot, a NaN and an inf entry
    give the plain version's inf/NaN pattern and its finite values (the
    integrator's convergence-failure path reads them)."""
    _need_card()
    rng = np.random.default_rng(b)
    A = rng.normal(size=(b, b, 6)) + b * np.eye(b)[:, :, None]
    A[:, :, 0] = 0.0
    A[0, :, 1] = 0.0
    A[2, :, 3] = 0.0
    A[2, 4, 3] = 1.0
    A[3, 5, 2] = np.nan
    A[1, 1, 4] = np.inf
    A = torch.from_numpy(A).cuda()
    r = torch.from_numpy(rng.normal(size=(b, 6))).cuda()
    for got, want in ((block_solve.block_inverse_soa(A),
                       block_solve.block_inverse_soa_plain(A)),
                      (block_solve.block_solve_soa(A, r),
                       block_solve.block_solve_soa_plain(A, r))):
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(got.isinf(), want.isinf())
        fin = want.isfinite()
        scale = max(1.0, want[fin].abs().max().item())
        assert (got[fin] - want[fin]).abs().max().item() <= 1e-10 * scale


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
    with pytest.raises(TypeError, match="dtype"):
        newton.lagrange_rescale(d["eta"], d["q"].long(), d["Z"], d["mask"])
    with pytest.raises(ValueError, match="history rows"):
        newton.lagrange_rescale(d["eta"], d["q"], d["Z"][:5].contiguous(),
                                d["mask"])
    with pytest.raises(ValueError, match="b=9 > 8"):
        newton.newton_residual_lsolve(
            d["r9"], d["r9"], d["r9"], d["gam"], d["gamrat"], d["A9"])
    with pytest.raises(ValueError, match="Minv has shape"):
        newton.newton_residual_lsolve(
            d["z3"], d["f3"], d["psi3"], d["gam"], d["gamrat"], d["Minv2"])


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


def _placed(t, off):
    """t's values in a fresh buffer, ``off`` elements past its start
    (a view at that many elements from a 16-byte boundary)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()]
    view.copy_(t)
    return view


def _offsets(dtype, k):
    """Offsets (in elements) for k inputs: all aligned, then each shift
    with the inputs misaligned differently from each other."""
    step = 16 // dtype.itemsize
    return [(0,) * k] + [tuple((s + i) % step for i in range(k))
                         for s in range(step)] + [(1,) * k]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", [1, 1000, 8193, 1 << 21, 3 << 20])
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
    # deterministic: the same input gives the same bits, also when the
    # same values lie elsewhere, x and y misaligned differently
    assert torch.equal(vecops.dot(x, y), got)
    for ox, oy in _offsets(dtype, 2):
        assert torch.equal(vecops.dot(_placed(x, ox), _placed(y, oy)), got), \
            (ox, oy)


# ---------------------------------------------------------------------------
# The scalar stack's N_Vector kernels: wrms_ss, wrms_mask_ss,
# scale_add_multi, dot_prod_multi; and the Brusselator demonstration
# ---------------------------------------------------------------------------

VEC_NS = [1, 130, 8193, 3 * 4099, 3 << 20, 3 * (1 << 20) + 5]


def _vec_inputs(n, K, dtype):
    rng = np.random.default_rng(n + K)
    d = {"x": rng.normal(size=n), "w": np.abs(rng.normal(size=n)) + 0.1,
         "m": (rng.uniform(size=n) > 0.3).astype(float),
         "Y": rng.normal(size=(K, n)), "c": rng.normal(size=K)}
    return {k: torch.from_numpy(v).to("cuda", dtype) for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", VEC_NS)
@pytest.mark.parametrize("masked", [False, True])
def test_wrms_reductions_match_plain_and_repeat_their_bits_on_card(
        masked, n, dtype):
    _need_card()
    d = _vec_inputs(n, 1, dtype)
    args = (d["x"], d["w"], d["m"]) if masked else (d["x"], d["w"])
    kern, plain, name = (vecops.wrms_mask_ss, vecops.wrms_mask_ss_plain,
                         "wrms_mask_ss") if masked else \
        (vecops.wrms_ss, vecops.wrms_ss_plain, "wrms_ss")
    kernels.reset_counts()
    got = kern(*args)
    assert kernels.counts()[name] == (1, 0)
    assert got.shape == () and got.device.type == "cuda"
    want = plain(*(a.double() for a in args))
    # a sum's rounding scales with the sum of its (nonnegative) terms
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert abs(got.item() - want.item()) <= tol * want.item()
    assert torch.equal(kern(*args), got)
    # the same values elsewhere, each input at its own offset: same bits
    for offs in _offsets(dtype, len(args)):
        placed = [_placed(a, o) for a, o in zip(args, offs)]
        assert torch.equal(kern(*placed), got), offs


@pytest.mark.cuda
def test_reductions_back_to_back_leave_their_counter_at_zero_on_card():
    """1000 reductions in a row on one stream, alternating lengths (one
    block, several, all 264) and kinds, each right: every launch finds
    its ticket counter at 0, as the last block of the one before left
    it.  The 3*2**20 cases (GMRES's vectors on the mesh) lie at 8 bytes
    from a 16-byte boundary, x and m, not w: looped misaligned launches
    give the aligned copies' bits."""
    _need_card()
    cases, aligned = [], {}
    for n in (130, 8193, (1 << 21) + 3, 3 << 20):
        d = _vec_inputs(n, 1, torch.float64)
        if n == 3 << 20:
            aligned = {vecops.dot: vecops.dot(d["x"], d["w"]),
                       vecops.wrms_ss: vecops.wrms_ss(d["x"], d["w"]),
                       vecops.wrms_mask_ss: vecops.wrms_mask_ss(
                           d["x"], d["w"], d["m"])}
            d = {k: _placed(d[k], 1 if k != "w" else 0)
                 for k in ("x", "w", "m")}
        cases.append((vecops.dot, (d["x"], d["w"])))
        cases.append((vecops.wrms_ss, (d["x"], d["w"])))
        cases.append((vecops.wrms_mask_ss, (d["x"], d["w"], d["m"])))
    want = [fn(*args) for fn, args in cases]
    torch.cuda.synchronize()
    got = [cases[i % len(cases)][0](*cases[i % len(cases)][1])
           for i in range(1000)]
    torch.cuda.synchronize()
    for i, g in enumerate(got):
        assert torch.equal(g, want[i % len(cases)]), i
    for (fn, _), w in zip(cases[-3:], want[-3:]):
        assert torch.equal(w, aligned[fn])
    for (fn, args), w in zip(cases, want):
        plain = getattr(vecops, fn.__name__ + "_plain")(*args)
        scale = args[0].abs().mul(args[1].abs()).sum().item()
        if fn is not vecops.dot:
            scale = plain.item()
        assert abs(w.item() - plain.item()) <= 1e-10 * scale


@pytest.mark.cuda
def test_reductions_on_a_second_stream_on_card():
    """A reduction on another stream gets its own partial sums and
    counter, and the same bits; launches on both streams at once stay
    right."""
    _need_card()
    d = _vec_inputs((1 << 21) + 1, 1, torch.float64)
    x, w, m = d["x"], d["w"], d["m"]
    main = torch.cuda.current_stream()
    want = (vecops.dot(x, w), vecops.wrms_ss(x, w), vecops.wrms_mask_ss(x, w, m))
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        on_side = [(vecops.dot(x, w), vecops.wrms_ss(x, w),
                    vecops.wrms_mask_ss(x, w, m)) for _ in range(50)]
    on_main = [(vecops.dot(x, w), vecops.wrms_ss(x, w),
                vecops.wrms_mask_ss(x, w, m)) for _ in range(50)]
    torch.cuda.synchronize()
    for got in on_side + on_main:
        for g, v in zip(got, want):
            assert torch.equal(g, v)
    keys = {k for k in vecops._SCRATCH if k[2] == torch.float64}
    assert {k[1] for k in keys} >= {main.cuda_stream, side.cuda_stream}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n", VEC_NS)
@pytest.mark.parametrize("K", [1, 2, 3, 5, 8])
def test_multi_vector_kernels_match_plain_on_card(K, n, dtype):
    _need_card()
    d = _vec_inputs(n, K, dtype)
    ys = list(d["Y"])
    # device scalars, a (K,) tensor and Python numbers all reach it
    for form in (d["c"], list(d["c"]), d["c"].tolist()):
        kernels.reset_counts()
        got = vecops.scale_add_multi(form, d["x"], ys)
        assert kernels.counts()["scale_add_multi"] == (1, 0)
        want = vecops.scale_add_multi_plain(form, d["x"], ys)
        torch.cuda.synchronize()
        assert got.shape == (K, n)
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= TOL[dtype] * scale
    kernels.reset_counts()
    got = vecops.dot_prod_multi(d["x"], ys)
    assert kernels.counts()["dot_prod_multi"] == (1, 0)
    assert got.shape == (K,)
    want = vecops.dot_prod_multi_plain(d["x"].double(),
                                       [y.double() for y in ys])
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    for k in range(K):
        scale = (d["x"].double() * ys[k].double()).abs().sum().item()
        assert abs(got[k].item() - want[k].item()) <= tol * scale
    assert torch.equal(vecops.dot_prod_multi(d["x"], ys), got)


@pytest.mark.cuda
def test_multi_vector_kernels_refuse_more_than_eight_vectors_on_card():
    _need_card()
    d = _vec_inputs(16, 9, torch.float64)
    with pytest.raises(ValueError, match="1 to 8"):
        vecops.dot_prod_multi(d["x"], list(d["Y"]))
    with pytest.raises(ValueError, match="1 to 8"):
        vecops.scale_add_multi(d["c"], d["x"], list(d["Y"]))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["task-local", "global"])
def test_brusselator_kernel_run_matches_plain_run_on_card(solver):
    """A small imex:ark324 Brusselator run through the kernels (rows 8,
    12, 14 and, for the global configuration, 16) against a run of the
    plain versions on the card."""
    _need_card()
    from repro_torch.apps import brusselator as br
    from repro_torch.configs.brusselator import BrusselatorConfig
    from repro_torch.core.policies import ExecPolicy
    cfg = BrusselatorConfig(nx=4096, solver=solver)
    kernels.reset_counts()
    y, st = br.integrate(cfg, t_final=0.05)
    counts = kernels.counts()
    want = ("block_solve", "linear_combination", "wrms_ss") + \
        (("dot",) if solver == "global" else ())
    assert all(counts[k][0] > 0 for k in want)
    assert all(c[1] == 0 for c in counts.values())
    ref, st_ref = br.integrate(cfg, t_final=0.05,
                               policy=ExecPolicy(backend="torch"))
    assert bool(st.success) and bool(st_ref.success)
    bound = 10 * (cfg.rtol * ref.abs() + cfg.atol)
    assert bool(((y - ref).abs() <= bound).all())
    assert int(st.steps) == int(st_ref.steps)


# ---------------------------------------------------------------------------
# Row 11: the scalar CSR SpMV of SparseCSR.matvec
# ---------------------------------------------------------------------------


def _csr_case(which, n, rng):
    """(indptr, indices, ncols): the §7 Brusselator's Jacobian pattern
    over n = 3*nx rows (4 sorted entries a row), or a ragged banded
    pattern of n rows with row lengths 0..9 (empty rows included)."""
    if which == "brusselator":
        indptr, indices, _ = jacobian_csr_pattern(n // 3)
        return indptr, indices, n
    lens = rng.integers(0, 10, size=n)
    cols = [np.unique(np.clip(r + rng.integers(-6, 7, size=k), 0, n - 1))
            for r, k in enumerate(lens)]
    indptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    return indptr, np.concatenate(cols).astype(np.int64), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("which,n", [("brusselator", 3 * 64),
                                     ("brusselator", 3 << 16),
                                     ("ragged", 133), ("ragged", 5000)])
def test_csr_spmv_matches_plain_on_card(which, n, dtype):
    _need_card()
    rng = np.random.default_rng(n)
    indptr, indices, ncols = _csr_case(which, n, rng)
    pattern = CSRPattern(indptr, indices, ncols)
    data = torch.from_numpy(rng.normal(size=pattern.nnz)).to(dtype).cuda()
    x = torch.from_numpy(rng.normal(size=ncols)).to(dtype).cuda()
    plan = pattern.kernel_plan(data.device)
    kernels.reset_counts()
    got = sparse.csr_spmv(data, x, *plan)
    assert kernels.counts()["csr_spmv"] == (1, 0)
    want = sparse.csr_spmv_plain(data, x, *plan)
    torch.cuda.synchronize()
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL[dtype] * scale
    empty = np.diff(indptr) == 0
    assert torch.equal(got[torch.from_numpy(empty).cuda()],
                       torch.zeros(int(empty.sum()), dtype=dtype,
                                   device="cuda"))
    with pytest.raises(ValueError, match="x has shape"):
        dv.csr_spmv(data, x[:-1], pattern)


def _telemetry_records(count, nsys, seed):
    """Seeded step records (RECORD_FIELDS order) as numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        active = rng.uniform(size=nsys) < 0.9
        conv = rng.uniform(size=nsys) < 0.8
        out.append((0.01 * (i + 1) + 1e-3 * rng.uniform(size=nsys),
                    10.0 ** rng.uniform(-8, 0, size=nsys),
                    rng.integers(1, 6, size=nsys).astype(np.int32),
                    rng.integers(0, 5, size=nsys).astype(np.int32),
                    rng.uniform(0, 2, size=nsys),
                    rng.uniform(size=nsys) < 0.3, conv,
                    conv & active & (rng.uniform(size=nsys) < 0.7), active))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("K,count", [(64, 40), (16, 40)])
def test_telemetry_ring_on_card(K, count):
    """The ring written on the card equals the one written on the CPU
    (which the CPU tests hold to the reference), and so do the
    chronological views, the per-lane sums and ``summary()``."""
    _need_card()
    from repro_torch import observability as obs
    nsys = 1000
    rings = {dev: obs.ring_init(K, (nsys,), torch.float64, dev)
             for dev in ("cpu", "cuda")}
    for rec in _telemetry_records(count, nsys, seed=K):
        for dev in rings:
            rings[dev] = obs.ring_record(rings[dev], tuple(
                torch.from_numpy(np.asarray(v)).to(dev) for v in rec))
    tels = {dev: obs.StepTelemetry(r) for dev, r in rings.items()}
    assert tels["cuda"].t.device.type == "cuda"
    for name in ("t", "h", "q", "newton_iters", "accepted", "active"):
        assert torch.equal(getattr(tels["cuda"], name).cpu(),
                           getattr(tels["cpu"], name)), name
    for name in ("steps", "attempts", "newton_iters_total", "lsetups"):
        got = getattr(tels["cuda"], name)()
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), getattr(tels["cpu"], name)()), name
    s_card, s_cpu = tels["cuda"].summary(), tels["cpu"].summary()
    e_card, e_cpu = s_card.pop("h_hist_log10"), s_cpu.pop("h_hist_log10")
    assert s_card == s_cpu
    assert np.allclose(e_card["edges"], e_cpu["edges"], rtol=0, atol=1e-12)
    assert e_card["counts"] == e_cpu["counts"]


@pytest.mark.cuda
def test_session_round_trip_and_telemetry_on_card():
    """A warm leg on the card from a session carried through numpy: the
    same bits run twice, the handle unchanged, the cold session equal to
    the session-free run, and the ring reconciled with the counters."""
    _need_card()
    from repro_torch import interop
    from repro_torch.core import batched, ivp, problems
    from repro_torch.core.arkode import ODEOptions
    nsys = 4096
    rates = problems.robertson_rates(nsys, seed=0)
    f, jac, y0 = problems.batched_robertson(nsys, rates=rates)
    prob = ivp.IVP(f=f, jac=jac, y0=y0)
    opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=100_000)
    plain = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", opts=opts)
    cold = ivp.integrate(prob, 0.0, 1.0, "ensemble_bdf", opts=opts,
                         session=batched.SolverSession.cold(y0, 0.0),
                         return_session=True, telemetry=256)
    assert torch.equal(cold.y, plain.y)
    tel = cold.telemetry
    for got, want in ((tel.steps(), cold.stats.steps),
                      (tel.attempts(), cold.stats.attempts),
                      (tel.newton_iters_total(), cold.stats.nni),
                      (tel.lsetups(), cold.stats.nsetups)):
        assert torch.equal(got.to(want.dtype), want)
    sess = interop.session_from_reference(
        interop.session_to_numpy(cold.session), device="cuda")
    before = [x.clone() for x in sess]
    prob2 = ivp.IVP(f=f, jac=jac, y0=cold.y)
    runs = [ivp.integrate(prob2, 1.0, 2.0, "ensemble_bdf", opts=opts,
                          session=sess) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(before, sess))
    assert torch.equal(runs[0].y, runs[1].y) and bool(runs[0].ok.all())


@pytest.mark.cuda
def test_profiler_synchronises_the_card():
    """A synchronising region on the card ends after the work it
    launched: the stream is idle at exit, and the span covers the
    work's device time."""
    _need_card()
    from repro_torch import observability as obs
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    prof = obs.Profiler(device="cuda")
    with prof.region("matmuls"):
        start.record()
        for _ in range(20):
            x = x @ x
            x = x / x.norm()
        end.record()
    assert torch.cuda.current_stream().query()
    assert prof.spans[0].dur * 1e3 >= start.elapsed_time(end)
    unsynced = obs.Profiler(device="cuda", sync=False)
    with unsynced.region("launch only"):
        pass
    assert unsynced.spans[0].name == "launch only"


def _serving_families():
    from repro_torch.core import problems
    from repro_torch.serve.solver import ProblemFamily
    fr, fd = problems.robertson_family(), problems.decay_chain_family(6)
    return [ProblemFamily("robertson", 3, *fr),
            ProblemFamily("decay6", 6, *fd)]


@pytest.mark.cuda
def test_server_bundles_match_a_direct_kernel_run_on_card():
    """The serving tier on the card: a Robertson bundle and a padded
    decay-chain bundle launch the main path's kernels, their lanes equal
    a direct ``integrate`` of the same systems (per-lane steps, nni and
    retcodes; y within 10*(rtol*|y|+atol)), a warm resubmission resumes
    from the sessions, and nothing degrades."""
    _need_card()
    from repro_torch.core import ivp, problems
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.serve.solver import SolverServer
    srv = SolverServer(_serving_families(), bucket_sizes=(256, 1024),
                       max_batch=1024)
    nrob, ndec = 1024, 200
    rates = problems.robertson_rates(nrob, seed=0)
    kdec = np.random.default_rng(1).uniform(0.1, 5.0, size=(ndec, 6))
    tol = {"rtol": 1e-5, "atol": 1e-10}
    rob = [srv.submit("robertson", [1.0, 0.0, 0.0], 0.0, 10.0, params={
        k: float(v[i]) for k, v in rates.items()}, **tol)
        for i in range(nrob)]
    dec = [srv.submit("decay6", np.ones(6), 0.0, 1.0, params={"k": k},
                      **tol) for k in kdec]
    kernels.reset_counts()
    srv.drain()
    for name in BDF_KERNELS:
        launches, calls = kernels.counts()[name]
        assert launches > 0 and calls == 0, name
    rob, dec = [f.result() for f in rob], [f.result() for f in dec]
    assert rob[0].y.device.type == "cuda"
    opts = ODEOptions(**tol, max_steps=100_000)
    f, jac, y0 = problems.batched_robertson(nrob, rates=rates)
    direct = ivp.integrate(ivp.IVP(f=f, jac=jac, y0=y0), 0.0, 10.0,
                           "ensemble_bdf", opts=opts)
    fd = problems.decay_chain_family(6)
    pk = {"k": torch.from_numpy(kdec).cuda()}
    ddirect = ivp.integrate(ivp.IVP(
        f=lambda t, y: fd[0](t, y, pk), jac=lambda t, y: fd[1](t, y, pk),
        f_soa=lambda t, y: fd[2](t, y, pk),
        jac_soa=lambda t, y: fd[3](t, y, pk),
        y0=torch.ones((ndec, 6), dtype=torch.float64, device="cuda")),
        0.0, 1.0, "ensemble_bdf", opts=opts)
    for sols, ref in ((rob, direct), (dec, ddirect)):
        y = torch.stack([s.y for s in sols])
        for name in ("steps", "nni", "retcodes"):
            got = torch.stack([getattr(s.stats, name) for s in sols])
            assert torch.equal(got, getattr(ref.stats, name)), name
        bound = 10 * (1e-5 * ref.y.abs() + 1e-10)
        assert bool(((y - ref.y).abs() <= bound).all())
    warm = [srv.submit("robertson", s.y, 10.0, 20.0, params={
        k: float(v[i]) for k, v in rates.items()}, session=s.session, **tol)
        for i, s in enumerate(rob[:256])]
    srv.drain()
    warm = [f.result() for f in warm]
    assert all(bool(s.ok) for s in warm[:4])
    assert int(torch.stack([s.stats.steps for s in warm]).sum()) < \
        int(direct.stats.steps[:256].sum())
    m = srv.metrics()
    assert m["failures"] == {} and m["degraded"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["nan", "divergent"])
def test_core_chaos_on_card(mode):
    """k poisoned lanes of 4096 on the card, the kernels: exactly those
    fail, healthy lanes bit for bit the clean run."""
    _need_card()
    from repro_torch.testing.chaos import run_core_chaos
    rep = run_core_chaos(4096, 8, seed=1, mode=mode)
    assert rep["device"].startswith("cuda") and rep["failed"] == 8
    allowed = {"CONV_FAILURE"} if mode == "nan" else {"ERR_FAILURE",
                                                      "CONV_FAILURE"}
    assert set(rep["retcodes"].values()) <= allowed


@pytest.mark.cuda
def test_serving_chaos_on_card():
    """Lane faults, deadline sheds, one degraded bundle and one failed
    fallback on the card: every future typed, none hung."""
    _need_card()
    from repro_torch.testing.chaos import run_serving_chaos
    rep = run_serving_chaos(2048, 16, 8, bucket=1024)
    assert rep["device"].startswith("cuda")
    assert rep["failed_retcode"] == 16 and rep["degraded_bundles"] == 1
    assert rep["failed_exec"] == 8


@pytest.mark.cuda
def test_a_kernel_refusing_its_inputs_fails_the_bundle_on_card():
    """A family whose SoA RHS comes back strided: the kernels refuse it,
    and the bundle's futures fail typed (``exec_error``); the bundle is
    not served by the plain versions in their place."""
    _need_card()
    from repro_torch.core import problems
    from repro_torch.serve.solver import ProblemFamily, SolverServer
    from repro_torch.serve.solver.server import SolverError
    fr = problems.robertson_family()

    def strided(t, z, p):
        return fr[2](t, z, p).T.contiguous().T

    srv = SolverServer([ProblemFamily("robertson", 3, fr[0], fr[1],
                                      strided, fr[3])],
                       bucket_sizes=(64,), max_batch=64)
    rates = problems.robertson_rates(64, seed=0)
    futs = [srv.submit("robertson", [1.0, 0.0, 0.0], 0.0, 1.0, params={
        k: float(v[i]) for k, v in rates.items()}, rtol=1e-5, atol=1e-10)
        for i in range(64)]
    with pytest.raises(Exception):
        srv.drain()
    for fut in futs:
        assert isinstance(fut.exception(), SolverError)
    m = srv.metrics()
    assert m["degraded"] == 0 and m["failures"] == {"exec_error": 64}


# ---------------------------------------------------------------------------
# The multi-device layer and the op registry on the card (path N's
# checks at 2**12 systems)
# ---------------------------------------------------------------------------

NSHARD = 1 << 12
#: the BDF loop's kernels under BlockDiagGJ(): the fused Newton
#: iteration and lsetup; under a pin of row 2 the residual and the
#: masked update take the iteration's place
BDF_KERNELS = ("newton_update", "lagrange_rescale", "wrms_soa",
               "newton_block_inverse")
PINNED_KERNELS = ("newton_residual", "masked_update_wrms") + BDF_KERNELS[1:]


def _robertson_family_problem(nsys):
    from repro_torch.core import problems
    rates = problems.robertson_rates(nsys, seed=0)
    params = {k: torch.as_tensor(v, device="cuda") for k, v in rates.items()}
    f, jac, _, _ = problems.robertson_family()
    y0 = torch.zeros((nsys, 3), dtype=torch.float64, device="cuda")
    y0[:, 0] = 1.0
    return f, jac, y0, params


def _group_of_one(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)


@pytest.mark.cuda
def test_sharded_world_of_one_is_the_unsharded_run_on_card(tmp_path):
    """``ensemble_bdf_integrate_sharded`` with no group and under an NCCL
    group of one: the unsharded kernel run bit for bit (y, every stats
    field, host syncs), the BDF kernels launched and no plain version."""
    _need_card()
    import torch.distributed as dist
    from repro_torch.core import batched
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.launch.mesh import WorldOfOne, make_ensemble_mesh
    f, jac, y0, params = _robertson_family_problem(NSHARD)
    opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=100_000)
    batched.reset_loop_counts()
    y1, st1 = batched.ensemble_bdf_integrate(
        lambda t, y: f(t, y, params), lambda t, y: jac(t, y, params), y0,
        0.0, 10.0, opts=opts)
    syncs = batched.loop_counts["host_syncs"]
    assert isinstance(make_ensemble_mesh(), WorldOfOne)
    for grouped in (False, True):
        if grouped:
            _group_of_one(tmp_path)
        try:
            kernels.reset_counts()
            batched.reset_loop_counts()
            y, st = batched.ensemble_bdf_integrate_sharded(
                f, jac, y0, 0.0, 10.0, params=params, opts=opts)
            assert batched.loop_counts["host_syncs"] == syncs
            assert torch.equal(y, y1)
            for name, a, b in zip(st._fields, st, st1):
                assert (a is None and b is None) or torch.equal(a, b), name
            counts = kernels.counts()
            for name in BDF_KERNELS:
                assert counts[name][0] > 0, name
            assert all(c[1] == 0 for c in counts.values())
        finally:
            if grouped:
                dist.destroy_process_group()


@pytest.mark.cuda
def test_a_pinned_run_launches_all_but_the_pinned_kernel_on_card():
    """``override(blockdiag_spmv_soa="torch")``: rows 1, 3, 4f, 5, 6f on
    their kernels, row 2 on its plain version only, the fused Newton
    iterations (rows 1+2f, 1+2+3f) never; y within 10*(rtol*|y|+atol) of
    the kernel run, retcodes equal."""
    _need_card()
    from repro_torch.core import ivp
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    f, jac, y0, params = _robertson_family_problem(NSHARD)
    prob = ivp.IVP(f=lambda t, y: f(t, y, params),
                   jac=lambda t, y: jac(t, y, params), y0=y0)
    opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=100_000)
    ref = ivp.integrate(prob, 0.0, 10.0, "ensemble_bdf", opts=opts)
    kernels.reset_counts()
    sol = ivp.integrate(prob, 0.0, 10.0, "ensemble_bdf", opts=opts._replace(
        policy=ExecPolicy().override(blockdiag_spmv_soa="torch")))
    counts = kernels.counts()
    launched, plain = counts["blockdiag_spmv"]
    assert launched == 0 and plain > 0
    assert counts["newton_residual_lsolve"] == counts["newton_update"] == \
        (0, 0)
    for name in PINNED_KERNELS:
        assert counts[name][0] > 0 and counts[name][1] == 0, name
    assert torch.equal(sol.retcodes, ref.retcodes)
    assert bool(((sol.y - ref.y).abs()
                 <= 10 * (1e-5 * ref.y.abs() + 1e-10)).all())


@pytest.mark.cuda
def test_the_fused_newton_iteration_is_the_composed_route_on_card():
    """``BlockDiagGJ()`` takes the fused Newton iteration (row 1+2+3f)
    and lsetup (row 6f); a pin of ``masked_update_wrms_soa`` to its
    kernel takes rows 1+2f and 3; a pin of ``newton_residual_soa`` to its
    plain version (which rounds as row 1) and of ``block_inverse_soa``
    to its kernel the residual, rows 2, 3 and 6.  The three runs agree
    bit for bit: y, every stats field, host syncs and trips, one fused
    launch a Newton trip and a lsetup."""
    _need_card()
    from repro_torch.core import batched
    from repro_torch.core.arkode import ODEOptions
    from repro_torch.core.policies import ExecPolicy
    f, jac, y0, params = _robertson_family_problem(NSHARD)
    opts = ODEOptions(rtol=1e-5, atol=1e-10, max_steps=100_000)
    runs = []
    for policy in (ExecPolicy(),
                   ExecPolicy().override(masked_update_wrms_soa="cuda"),
                   ExecPolicy().override(newton_residual_soa="torch",
                                         block_inverse_soa="cuda")):
        kernels.reset_counts()
        batched.reset_loop_counts()
        y, st = batched.ensemble_bdf_integrate(
            lambda t, y: f(t, y, params), lambda t, y: jac(t, y, params), y0,
            0.0, 10.0, opts=opts, policy=policy)
        runs.append((y, st, dict(batched.loop_counts), kernels.counts()))
    (y, st, loops, c), (y1, st1, loops1, c1), (y2, st2, loops2, c2) = runs
    trips, lsetups = loops["newton_trips"], loops["lsetups"]
    assert c["newton_update"][0] == trips > 0
    assert c["newton_block_inverse"][0] == lsetups > 0
    for name in ("newton_residual", "blockdiag_spmv", "newton_residual_lsolve",
                 "masked_update_wrms", "block_inverse"):
        assert c[name] == (0, 0), name
    assert c1["newton_residual_lsolve"][0] == c1["masked_update_wrms"][0] == \
        trips and c1["newton_update"] == (0, 0)
    assert c1["newton_residual"] == c1["blockdiag_spmv"] == (0, 0)
    assert c1["newton_block_inverse"][0] == lsetups
    assert c2["blockdiag_spmv"][0] == c2["newton_residual"][1] == \
        c2["masked_update_wrms"][0] == trips
    assert c2["block_inverse"][0] == lsetups
    assert c2["newton_update"] == c2["newton_block_inverse"] == \
        c2["newton_residual_lsolve"] == (0, 0)
    for y_, st_, loops_ in ((y1, st1, loops1), (y2, st2, loops2)):
        assert loops == loops_ and torch.equal(y, y_)
        for name, a, b in zip(st._fields, st, st_):
            assert (a is None and b is None) or torch.equal(a, b), name


@pytest.mark.cuda
def test_explicit_mesh_vector_under_a_group_of_one_on_card(tmp_path,
                                                          monkeypatch):
    """Explicit-mode reductions over a layout of one NCCL rank: each one
    collective and, for ``dot`` and ``wrms_norm``, one launch of rows 16
    and 14; the values are the plain dispatch ops' bit for bit (a sum
    over one rank is the identity)."""
    _need_card()
    import torch.distributed as dist
    from repro_torch.core import dispatch, vector
    from repro_torch.launch.mesh import make_ensemble_mesh
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=3 * 2**12 + 5)).cuda()
    w = torch.from_numpy(np.abs(rng.normal(size=x.numel())) + 0.1).cuda()
    calls = []
    real = dist.all_reduce

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(dist, "all_reduce", counted)
    _group_of_one(tmp_path)
    try:
        mesh = make_ensemble_mesh()
        spec = vector.MeshVectorSpec(comm=mesh, mode="explicit")
        mx, mw = vector.MeshVector(x, spec), vector.MeshVector(w, spec)
        for name, fn, want, kernel in (
                ("dot", lambda: mx.dot(mw), dispatch.dot(x, w), "dot"),
                ("wrms_norm", lambda: mx.wrms_norm(mw, global_size=x.numel()),
                 dispatch.wrms_norm(x, w), "wrms_ss"),
                ("l1_norm", mx.l1_norm, vector.l1_norm(x), None),
                ("max_norm", mx.max_norm, vector.max_norm(x), None),
                ("min", mx.min, vector.vmin(x), None)):
            kernels.reset_counts()
            before = len(calls)
            got = fn()
            assert len(calls) - before == 1, name
            if kernel is not None:
                assert kernels.counts()[kernel] == (1, 0), name
            assert torch.equal(got, want), name
        assert torch.equal(mx.linear_sum(0.5, -2.0, mw).data,
                           dispatch.linear_sum(0.5, x, -2.0, w))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the analysis layer on the card: the tuner, "auto" from a cache, the
# card's roofline row, kernel-contract with its card half
# ---------------------------------------------------------------------------


def _sig(op, **kw):
    from repro_torch.analysis.opcost import OpSig
    return OpSig(op, "float64", **kw)


@pytest.mark.cuda
def test_tune_times_both_implementations_on_the_card(tmp_path):
    _need_card()
    import math
    from repro_torch.core import autotune
    sigs = [_sig("wrms_soa", n=3, nsys=4096),
            _sig("block_inverse_soa", n=3, nsys=4096, b=3),
            _sig("dot", n=4096, k=1)]
    cache = autotune.tune(cases=sigs, reps=5, path=tmp_path, verbose=False)
    assert cache.path.parent == tmp_path
    assert [cache.get(s) is not None for s in sigs] == [True] * 3
    for e in cache.entries.values():
        assert all(math.isfinite(t) and t > 0 for t in (e.t_torch, e.t_cuda))
    back = autotune.AutotuneCache(cache.device, path=cache.path).load()
    assert set(back.entries) == set(cache.entries) and not back.stale


@pytest.mark.cuda
def test_auto_takes_the_cache_then_the_model_on_the_card(tmp_path,
                                                         monkeypatch):
    """The decisions come from the cache, a near entry, then the model;
    each call launches the kernel whatever was decided, and only a pin
    runs the plain version on the card."""
    _need_card()
    from repro_torch.analysis.roofline import device_for
    from repro_torch.core import autotune
    from repro_torch.core.context import Context
    from repro_torch.core.policies import ExecPolicy
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_DIR", str(tmp_path))
    row = device_for("cuda")
    cache = autotune.AutotuneCache(row)
    # a made-up measurement in which the plain version wins
    cache.put(autotune.Entry(_sig("wrms_soa", n=3, nsys=512), 1e-6, 2e-6))
    cache.save()
    autotune.reset_resolver()
    try:
        ctx = Context(policy=ExecPolicy())
        v = torch.rand(3, 512, dtype=torch.float64, device="cuda")
        w = torch.rand(3, 4096, dtype=torch.float64, device="cuda")
        want = dv.OP_TABLE["wrms_soa"]["cuda"](v, v)
        kernels.reset_counts()
        for _ in range(2):
            assert torch.equal(dv.wrms_soa(v, v, ctx.policy), want)
        dv.wrms_soa(w, w, ctx.policy)         # 8x the entry's: near
        assert kernels.counts()["wrms_soa"] == (3, 0)
        rep = ctx.dispatch_report()
        got = {d["sig"]: (d["backend"], d["source"], d["hits"])
               for d in rep["decisions"]}
        assert got == {_sig("wrms_soa", n=3, nsys=512).key():
                       ("torch", "cache", 2),
                       _sig("wrms_soa", n=3, nsys=4096).key():
                       ("torch", "near", 1)}
        big = torch.rand(3, 1 << 16, dtype=torch.float64, device="cuda")
        dv.wrms_soa(big, big, ctx.policy)     # 128x: the model's kernel
        assert kernels.counts()["wrms_soa"] == (4, 0)
        assert rep["cache_entries"] == 1
        pinned = ExecPolicy().override(wrms_soa="torch")
        dv.wrms_soa(v, v, pinned)             # the pin: the plain version
        assert kernels.counts()["wrms_soa"] == (4, 1)
    finally:
        autotune.reset_resolver()


@pytest.mark.cuda
def test_device_for_names_this_cards_row():
    _need_card()
    from repro_torch.analysis import roofline
    name = torch.cuda.get_device_name(0)
    rows = {r.card: r.name for r in roofline.DEVICES.values()}
    if name in rows:
        assert roofline.device_for("cuda:0") == rows[name]
    else:
        with pytest.raises(ValueError, match="no roofline row"):
            roofline.device_for("cuda:0")


@pytest.mark.cuda
def test_kernel_contract_with_the_card_present():
    _need_card()
    from repro_torch.analysis import lint
    ctx = lint.LintContext()
    assert ctx.cuda
    assert lint.run_rules(ctx, ["kernel-contract"]) == []


# ---------------------------------------------------------------------------
# the model stack's serving half (models/, serve/decode) on the card
# ---------------------------------------------------------------------------

#: card against CPU, float32: max |card - cpu| <= MODEL_TOL * max(1,
#: max |cpu|) (two layers of float32 products of widths <= 256)
MODEL_TOL = 1e-4


def _model_pair(arch, dtype=torch.float32):
    from repro_torch import configs
    from repro_torch.models import Model, spec
    model = Model(configs.get(f"{arch}-smoke").replace(dtype=dtype))
    cpu = model.init(torch.Generator().manual_seed(0))
    return model, cpu, spec.tree_map(lambda a: a.to("cuda"), cpu)


def _smoke_batch(cfg, dev):
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=gen, dtype=torch.int32),
             "targets": torch.randint(0, cfg.vocab_size, (2, 12),
                                      generator=gen, dtype=torch.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = 0.02 * torch.randn(2, 4, cfg.d_model,
                                                 generator=gen)
    if cfg.enc_dec:
        batch["frames"] = 0.02 * torch.randn(2, 8, cfg.d_model, generator=gen)
    return {k: v.to(dev, cfg.dtype) if v.is_floating_point() else v.to(dev)
            for k, v in batch.items()}


def _rel(a, b):
    return float((a.cpu() - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "dbrx-132b",
                                  "xlstm-125m", "qwen2-vl-2b",
                                  "internlm2-1.8b", "deepseek-coder-33b",
                                  "qwen2-72b", "starcoder2-7b", "zamba2-7b",
                                  "whisper-tiny"])
def test_model_forward_and_decode_card_against_cpu(arch):
    """Each smoke config in float32: the forward logits, the loss and
    three decode steps' logits and caches on the card agree with the CPU
    (which the CPU tests hold to the JAX package)."""
    _need_card()
    from repro_torch.models import spec
    model, cpu, card = _model_pair(arch)
    cfg = model.cfg
    with torch.no_grad():
        outs = {}
        for dev, params in (("cpu", cpu), ("cuda", card)):
            batch = _smoke_batch(cfg, dev)
            caches = model.init_cache(2, 8, device=dev)
            steps = []
            for i in range(3):
                db = {"tokens": batch["tokens"][:, i:i + 1], "pos": i}
                if cfg.enc_dec:
                    db["enc_out"] = batch["frames"]
                steps.append(model.decode_step(params, db, caches)[0])
            outs[dev] = ([model.forward(params, batch),
                          model.loss(params, batch)] + steps
                         + spec.tree_leaves(caches))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert got.device.type == "cuda"
        assert _rel(got.float(), want.float()) <= MODEL_TOL, arch


@pytest.mark.cuda
def test_generate_on_the_card_matches_the_cpu():
    _need_card()
    from repro_torch.serve import decode
    model, cpu, card = _model_pair("internlm2-1.8b")
    prompt = torch.randint(0, model.cfg.vocab_size, (3, 5),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    got = decode.generate(model, card, prompt, 6)       # default: the card
    want = decode.generate(model, cpu, prompt, 6, device="cpu")
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_bf16_decode_steps_on_the_card_are_finite_and_in_place():
    _need_card()
    from repro_torch.serve import decode
    model, _, card = _model_pair("qwen2-72b", torch.bfloat16)
    caches = model.init_cache(4, 16)
    ptr = caches["k"].data_ptr()
    step = decode.make_serve_step(model)
    tok = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    for pos in range(4):
        logits, out = step(card, {"tokens": tok, "pos": pos}, caches)
        assert out is caches and caches["k"].data_ptr() == ptr
        assert logits.dtype == torch.bfloat16
        assert bool(torch.isfinite(logits).all())
        tok = decode.sample_token(logits)
    assert caches["pos"].tolist() == [4] * model.cfg.n_layers


@pytest.mark.cuda
def test_walker_clean_on_the_card():
    """sunlint's dispatch walker over the main path's first steps on the
    card, under the kernels: no finding."""
    _need_card()
    from repro_torch.analysis import hotloop, lint
    ctx = lint.LintContext()
    ctx.hot_loop_targets = hotloop.robertson_targets(nsys=4096,
                                                     device="cuda")
    assert lint.run_rules(ctx, ["hot-loop-layout", "dtype-drift"]) == []
    assert all(ctx.hot_loop_trace(t).calls for t in ctx.hot_loop_targets)


def _train_states(model):
    """One initial TrainState on the CPU and its copy on the card."""
    from repro_torch.models import spec
    from repro_torch.train import step as tstep
    st = tstep.init_state(model, torch.Generator().manual_seed(0),
                          device="cpu")
    card = tstep.TrainState(
        params=spec.tree_map(lambda a: a.to("cuda"), st.params),
        opt=type(st.opt)(*(spec.tree_map(lambda a: a.to("cuda"), x)
                           for x in st.opt)))
    return st, card


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    """One smoke AdamW step in float32 (remat on) on the card against the
    CPU: the loss within 1e-5 relative, the gradient norm within 1e-4,
    moments within 1e-4 of each leaf's scale, params within 2*lr + 1e-6;
    row 16's kernel computes the norm on the card (one launch a leaf)."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import Model, spec
    from repro_torch.optim import adamw
    from repro_torch.train import step as tstep
    model = Model(configs.get("internlm2-1.8b-smoke").replace(
        dtype=torch.float32, remat=True))
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    cpu, card = _train_states(model)
    batch = _smoke_batch(model.cfg, "cpu")
    train = tstep.make_train_step(model, ocfg=ocfg)
    kernels.reset_counts()
    card, met = train(card, {k: v.to("cuda") for k, v in batch.items()})
    n_leaves = len(spec.tree_leaves(card.params))
    assert kernels.counts()["dot"] == (n_leaves, 0)
    cpu, want = train(cpu, batch)
    assert abs(float(met["loss"]) - float(want["loss"])) <= \
        1e-5 * float(want["loss"])
    assert abs(float(met["grad_norm"]) - float(want["grad_norm"])) <= \
        1e-4 * float(want["grad_norm"])
    for name in ("m", "v"):
        for a, b in zip(spec.tree_leaves(getattr(card.opt, name)),
                        spec.tree_leaves(getattr(cpu.opt, name))):
            assert a.is_cuda
            assert float((a.cpu() - b).abs().max()) <= \
                1e-4 * float(b.abs().max())
    for a, b in zip(spec.tree_leaves(card.params),
                    spec.tree_leaves(cpu.params)):
        assert float((a.cpu() - b).abs().max()) <= 2 * ocfg.lr + 1e-6


@pytest.mark.cuda
def test_checkpoint_round_trip_of_a_card_state(tmp_path):
    """A bf16 TrainState on the card saved and restored onto the card:
    every leaf bit for bit, dtypes and device kept."""
    _need_card()
    from repro_torch import configs
    from repro_torch.models import Model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import step as tstep
    model = Model(configs.get("internlm2-1.8b-smoke"))
    _, card = _train_states(model)
    card.opt.m["embed"].normal_()
    ckpt.save(card, str(tmp_path), 7)
    back = ckpt.restore(tstep.abstract_state(model), str(tmp_path), 7)
    for (pa, a), (pb, b) in zip(ckpt._leaves_with_path(card),
                                ckpt._leaves_with_path(back)):
        assert pa == pb and b.is_cuda and a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_tensors_never_take_the_abstract_route():
    """Under ``analysis.stepcost.StepCost`` (the dry run's counter) a
    call on the card's tensors launches its kernel and is counted under
    no row; only a meta tensor takes the plain version, under its row."""
    _need_card()
    from repro_torch.analysis.stepcost import StepCost
    x = torch.arange(1, 1025, dtype=torch.float32, device="cuda")
    meta = torch.empty(1024, dtype=torch.float32, device="meta")
    kernels.reset_counts()
    with StepCost() as sc:
        d = dv.dot(x, x)
        w = dv.wrms_ss(x, x)
        z = dv.linear_combination([1.0, 2.0], [x, x])
    assert sc.rows == {}
    counts = kernels.counts()
    for name in ("dot", "wrms_ss", "linear_combination"):
        assert counts[name] == (1, 0), (name, counts[name])
    assert float(d) == float((x.double() * x.double()).sum())
    assert float(w) > 0 and torch.equal(z, 3 * x)
    kernels.reset_counts()
    with StepCost() as sc:
        dv.dot(meta, meta)
    assert sc.rows["dot"][0] == 1 and kernels.counts()["dot"] == (0, 1)
