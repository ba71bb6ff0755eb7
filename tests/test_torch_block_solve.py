"""The port's batched Gauss-Jordan solve against the JAX reference.

``block_solve_soa_plain`` (what the port's wrapper runs for CPU tensors,
and what the CUDA kernels are held to on the card) against the
reference's Pallas kernels in interpret mode and its jnp oracle
``repro.kernels.ref.block_solve_soa_ref``, on the same float64 inputs
made from a numpy seed, at b on both sides of the unrolled/tiled split
(8) and at ragged batch sizes.

Tolerance: |port - reference| <= 1e-10 * max(1, |x|).  The Pallas path
is the algorithmic twin (no pivoting, the same row scaling and
elimination order), so it agrees to a few ulps.  The reference's jnp
backend is a different algorithm: ``dispatch.block_solve_soa`` under jnp
runs ``direct.gauss_jordan_batched``, which pivots
(``src/repro/core/direct.py:30``), and the oracle is ``jnp.linalg.solve``
(LU with partial pivoting); on these well-conditioned Newton blocks all
agree far inside the tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import dispatch as rdv
from repro.core.policies import ExecPolicy as RefPolicy
from repro.kernels import ref as kref
from repro_torch import kernels
from repro_torch.core import dispatch as dv
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import block_solve

PALLAS = RefPolicy(backend="pallas", interpret=True, batch_tile=128)
NBS = [7, 130, 516]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    atol = 1e-10 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(port, ref, rtol=0, atol=atol)


def _newton_blocks(b, nb, seed):
    """M = I - gamma*J with a random J and gamma in [1e-3, 1e-1]: the
    diagonally dominant blocks the no-pivot elimination is for."""
    rng = np.random.default_rng(seed)
    J = rng.normal(size=(b, b, nb))
    gam = 10.0 ** rng.uniform(-3, -1, size=nb)
    return np.eye(b)[:, :, None] - gam * J, rng.normal(size=(b, nb))


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", [1, 3, 8, 9, 16, 24, 32, 33])
def test_block_solve_matches_reference(b, nb):
    """b <= 8 reaches the reference's _gj_kernel, b > 8 its
    _gj_tiled_kernel; the port's plain version picks the same body
    (b = 9 to 32 run the CUDA warp-per-system form on the card, b = 33
    the form that works in device memory)."""
    A, r = _newton_blocks(b, nb, seed=b * 1000 + nb)
    body = "unrolled" if b <= 8 else "tiled"
    before = getattr(block_solve.block_solve_soa_plain, f"calls_{body}")
    port = block_solve.block_solve_soa_plain(_t(A), _t(r))
    assert getattr(block_solve.block_solve_soa_plain,
                   f"calls_{body}") == before + 1
    assert port.shape == (b, nb) and port.dtype == torch.float64
    _close(port, rdv.block_solve_soa(jnp.asarray(A), jnp.asarray(r), PALLAS))
    _close(port, kref.block_solve_soa_ref(jnp.asarray(A), jnp.asarray(r)))


def _robertson_dirk_blocks(nb, seed=0):
    """The DIRK stage Newton blocks of batched Robertson: M = I - h*a_ii*J
    at Robertson states, with gamma = h*a_ii over eight decades and k3
    up to 3e8, so the entries span many decades (what row scaling is
    for)."""
    rng = np.random.default_rng(seed)
    k1 = np.full(nb, 0.04)
    k2 = 1e4 * (0.5 + rng.uniform(size=nb))
    k3 = 3e7 * 10.0 ** rng.uniform(-1, 1, size=nb)
    b = 10.0 ** rng.uniform(-8, -4, size=nb)
    c = rng.uniform(size=nb)
    z = np.zeros(nb)
    J = np.array([[-k1, k2 * c, k2 * b],
                  [k1, -k2 * c - 2 * k3 * b, -k2 * b],
                  [z, 2 * k3 * b, z]])
    gam = 10.0 ** rng.uniform(-8, 0, size=nb) * (1 - 1 / np.sqrt(2))
    return np.eye(3)[:, :, None] - gam * J, rng.normal(size=(3, nb))


@pytest.mark.parametrize("nb", NBS)
def test_block_solve_stiff_robertson_newton_blocks(nb):
    M, r = _robertson_dirk_blocks(nb)
    port = block_solve.block_solve_soa_plain(_t(M), _t(r)).numpy()
    _close(port, rdv.block_solve_soa(jnp.asarray(M), jnp.asarray(r), PALLAS))
    resid = np.einsum("ijs,js->is", M, port) - r
    scale = np.einsum("ijs,js->is", np.abs(M), np.abs(port)) + np.abs(r)
    assert np.all(np.abs(resid) <= 1e-12 * scale)


@pytest.mark.parametrize("b", [3, 16])
def test_solve_agrees_with_inverse(b):
    """Both Gauss-Jordan entries of the port describe the same matrix."""
    A, r = _newton_blocks(b, 130, seed=b)
    x = block_solve.block_solve_soa_plain(_t(A), _t(r))
    inv = block_solve.block_inverse_soa_plain(_t(A))
    np.testing.assert_allclose(x.numpy(), np.einsum("ijs,js->is", inv.numpy(),
                                                    r), rtol=0, atol=1e-12)


def test_counts_name_each_body():
    A3, r3 = _newton_blocks(3, 7, seed=1)
    A16, r16 = _newton_blocks(16, 7, seed=2)
    kernels.reset_counts()
    block_solve.block_solve_soa(_t(A3), _t(r3))
    block_solve.block_solve_soa(_t(A16), _t(r16))
    block_solve.block_solve_soa(_t(A16), _t(r16))
    block_solve.block_inverse_soa(_t(A16))
    c = kernels.counts()
    assert c["block_solve"] == (0, 1)
    assert c["block_solve_tiled"] == (0, 2)
    assert c["block_inverse"] == (0, 0)
    assert c["block_inverse_tiled"] == (0, 1)
    kernels.reset_counts()
    assert all(v == (0, 0) for v in kernels.counts().values())


def test_dispatch_routes_block_solve():
    A, r = _newton_blocks(3, 130, seed=3)
    want = block_solve.block_solve_soa_plain(_t(A), _t(r))
    for policy in (ExecPolicy(), ExecPolicy(backend="torch")):
        assert torch.equal(dv.block_solve_soa(_t(A), _t(r), policy), want)
    with pytest.raises(ValueError, match="backend 'cuda'"):
        dv.block_solve_soa(_t(A), _t(r), ExecPolicy(backend="cuda"))
    # a meta tensor (the dry run's: no data) takes the plain version
    out = block_solve.block_solve_soa(_t(A).to("meta"), _t(r).to("meta"))
    assert out.device.type == "meta" and out.shape == want.shape
