"""The port's ensemble-BDF kernels against the JAX reference.

Each op's plain PyTorch version (what the port's wrappers run for CPU
tensors) is held to the reference's jnp oracle (``repro.kernels.ref``)
AND to the reference's Pallas kernel in interpret mode, on the same
float64 inputs made from a numpy seed, at ragged batch sizes.  The CUDA
kernels themselves run only on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import cvode as rcv
from repro.core import dispatch as rdv
from repro.core.policies import ExecPolicy as RefPolicy
from repro.kernels import ref as kref
from repro_torch import kernels
from repro_torch.core import dispatch as dv
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import block_solve, blockdiag_spmv, newton

PALLAS = RefPolicy(backend="pallas", interpret=True, batch_tile=128)
TORCH = ExecPolicy(backend="torch")
ATOL = 1e-10
NBS = [7, 130, 516]
N, Q1 = 3, 6


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(port, *refs, atol=ATOL):
    for ref in refs:
        np.testing.assert_allclose(_np(port), _np(ref), rtol=0, atol=atol)


def _data(nb, seed=0, n=N):
    rng = np.random.default_rng(seed)
    return {
        "z": rng.normal(size=(n, nb)), "f": rng.normal(size=(n, nb)),
        "psi": rng.normal(size=(n, nb)),
        "gam": np.abs(rng.normal(size=(nb,))),
        "w": np.abs(rng.normal(size=(n, nb))) + 0.1,
        "mask": rng.uniform(size=(nb,)) > 0.4,
        "W": rng.normal(size=(Q1, Q1, nb)),
        "Z": rng.normal(size=(Q1, n, nb)),
        "A": rng.normal(size=(n, n, nb)),
    }


#: (n, nb) of the history rescale and the per-system WRMS: the Robertson
#: state (n = 3, its ids nb alone) and the Brusselator ensemble's n = 32
#: (the CUDA kernels' second layout); ragged batches
STATE_CASES = [pytest.param(n, nb, id=str(nb) if n == N else f"n{n}-{nb}")
               for n in (N, 32) for nb in NBS]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("nb", NBS)
def test_newton_residual(nb, negate):
    d = _data(nb)
    args = [d[k] for k in ("z", "f", "psi", "gam")]
    port = newton.newton_residual_plain(*map(_t, args), negate=negate)
    _close(port, kref.newton_residual_soa_ref(*map(jnp.asarray, args),
                                              negate=negate),
           rdv.newton_residual_soa(*map(jnp.asarray, args), PALLAS,
                                   negate=negate))


#: (b, nb) of the SpMV: the Robertson block (b = 3, its ids nb alone),
#: the CUDA row form's edges (9, 32) and a width between; ragged batches
SPMV_CASES = [pytest.param(b, nb, id=str(nb) if b == N else f"b{b}-{nb}")
              for b in (N, 9, 16, 32) for nb in NBS]


@pytest.mark.parametrize("b, nb", SPMV_CASES)
def test_blockdiag_spmv(b, nb):
    rng = np.random.default_rng([b, nb])
    A, x = rng.normal(size=(b, b, nb)), rng.normal(size=(b, nb))
    port = blockdiag_spmv.blockdiag_spmv_soa_plain(_t(A), _t(x))
    A, x = jnp.asarray(A), jnp.asarray(x)
    _close(port, kref.blockdiag_spmv_soa_ref(A, x),
           rdv.blockdiag_spmv_soa(A, x, PALLAS))


@pytest.mark.parametrize("nb", NBS)
def test_masked_update_wrms(nb):
    d = _data(nb)
    z_p, dn_p = newton.masked_update_wrms_plain(
        _t(d["z"]), _t(d["f"]), _t(d["w"]), _t(d["mask"]))
    args = [jnp.asarray(d[k]) for k in ("z", "f", "w", "mask")]
    z_r, dn_r = kref.masked_update_wrms_soa_ref(*args)
    z_k, dn_k = rdv.masked_update_wrms_soa(*args, PALLAS)
    _close(z_p, z_r, z_k)
    _close(dn_p, dn_r, dn_k)
    # the norm covers masked-out systems too (newton.py:90-91)
    assert np.all(_np(dn_p)[~d["mask"]] > 0)


@pytest.mark.parametrize("n, nb", STATE_CASES)
def test_history_rescale(n, nb):
    d = _data(nb, n=n)
    port = newton.history_rescale_plain(_t(d["W"]), _t(d["Z"]),
                                        _t(d["mask"]))
    args = [jnp.asarray(d[k]) for k in ("W", "Z", "mask")]
    _close(port, kref.history_rescale_soa_ref(*args),
           rdv.history_rescale_soa(*args, PALLAS))
    # inactive systems pass through bit-exactly
    off = ~d["mask"]
    assert np.array_equal(_np(port)[:, :, off], d["Z"][:, :, off])
    none = newton.history_rescale_plain(_t(d["W"]), _t(d["Z"]),
                                        torch.zeros(nb, dtype=torch.bool))
    assert np.array_equal(_np(none), d["Z"])


def _eta_q(nb, rng):
    """Step ratios over [0.1, 10] (every fifth exactly 1) and valid
    history counts q over 0..5, each q at least once."""
    eta = 10.0 ** rng.uniform(-1, 1, size=nb)
    eta[::5] = 1.0
    q = rng.permutation(np.arange(nb) % (Q1))[:nb].astype(np.int32)
    return eta, q


@pytest.mark.parametrize("n, nb", STATE_CASES)
def test_lagrange_rescale(n, nb):
    """The fused rebuild's plain version against the reference: W
    (``lagrange_matrix_soa``) equal to ``vmap(cvode._lagrange_matrix)``
    bit for bit, and the rescale with it against the reference's oracle
    and Pallas kernel fed the reference's W; inactive systems (the eta =
    1 lanes among them) pass through bit-exactly."""
    rng = np.random.default_rng([n, nb])
    eta, q = _eta_q(nb, rng)
    Z = rng.normal(size=(Q1, n, nb))
    active = (rng.uniform(size=nb) > 0.4) & (eta != 1.0)
    W_ref = np.asarray(jax.vmap(rcv._lagrange_matrix)(
        jnp.asarray(eta), jnp.asarray(q))).transpose(1, 2, 0)
    W = newton.lagrange_matrix_soa(_t(eta), _t(q))
    assert np.array_equal(_np(W), W_ref)
    assert np.array_equal(np.signbit(_np(W)), np.signbit(W_ref))
    kernels.reset_counts()
    port = dv.lagrange_rescale_soa(_t(eta), _t(q), _t(Z), _t(active))
    assert kernels.counts()["lagrange_rescale"] == (0, 1)
    args = [jnp.asarray(a) for a in (W_ref, Z, active)]
    ref = kref.history_rescale_soa_ref(*args)
    # W reaches ~1e7 at eta = 10, q = 5 (the new nodes lie up to 50 old
    # steps out): 1e-10 of the output's scale, as the card tests hold
    _close(port, ref, rdv.history_rescale_soa(*args, PALLAS),
           atol=ATOL * max(1.0, float(np.abs(ref).max())))
    off = ~active
    assert np.array_equal(_np(port)[:, :, off], Z[:, :, off])
    assert torch.equal(port, newton.history_rescale_plain(W, _t(Z),
                                                          _t(active)))


def _lagrange_quotient(p, d):
    """The CUDA kernel's p / d (``newton.cu`` ``lagrange_quotient``): a
    product with the exact reciprocal for d = +-1, +-2, +-4."""
    return p / d if abs(d) in (3, 5) else p * (1.0 / d)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lagrange_matrix_in_kernel_order(dtype):
    """The CUDA kernel's W entry by entry (``newton.cu``
    ``lagrange_entry``: (-j)*eta + k, the quotient, the running product
    under k <= q, then the identity rows and zero columns), written out
    in PyTorch, equals ``lagrange_matrix_soa`` bit for bit, signed zeros
    included: what lets the fused kernel equal its plain version."""
    rng = np.random.default_rng(7)
    eta, q = _eta_q(516, rng)
    eta = torch.from_numpy(eta).to(dtype)
    q = torch.from_numpy(q)
    want = newton.lagrange_matrix_soa(eta, q)
    got = torch.empty_like(want)
    one = torch.ones((), dtype=dtype)
    for j in range(Q1):
        p = -torch.tensor(float(j), dtype=dtype) * eta
        for i in range(Q1):
            w = torch.ones_like(eta)
            for k in range(Q1):
                if k != i:
                    f = _lagrange_quotient(p + k, k - i)
                    w = torch.where(k <= q, w * f, w)
            ident = one if i == j else torch.zeros((), dtype=dtype)
            got[j, i] = torch.where(j > q, ident,
                                    torch.where(i > q, 0.0 * one, w))
    assert torch.equal(got, want)
    assert torch.equal(got.signbit(), want.signbit())


@pytest.mark.parametrize("n, nb", STATE_CASES)
def test_wrms_soa(n, nb):
    d = _data(nb, n=n)
    port = newton.wrms_soa_plain(_t(d["z"]), _t(d["w"]))
    v, w = jnp.asarray(d["z"]), jnp.asarray(d["w"])
    _close(port, kref.wrms_soa_ref(v, w), rdv.wrms_soa(v, w, PALLAS))


@pytest.mark.parametrize("nb", NBS)
@pytest.mark.parametrize("b", [3, 8, 9, 16, 24, 32, 33])
def test_block_inverse(b, nb):
    """b <= 8 and b > 8 reach the reference's two Pallas bodies
    (_gj_inverse_kernel, _gj_tiled_inverse_kernel); b = 9 and 32 are
    the edges of the CUDA warp-per-system form, 33 the first b of the
    form that works in device memory."""
    rng = np.random.default_rng(b * 1000 + nb)
    A = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
    port = block_solve.block_inverse_soa_plain(_t(A))
    _close(port, kref.block_inverse_soa_ref(jnp.asarray(A)),
           rdv.block_inverse_soa(jnp.asarray(A), PALLAS))


def _robertson_newton_blocks(nb, seed=0):
    """M = I - gamma*J at Robertson states: k3 up to 3e8 and gamma over
    eight decades make the entries span many decades, the case row
    scaling exists for."""
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
    gam = 10.0 ** rng.uniform(-8, 0, size=nb)
    return np.eye(3)[:, :, None] - gam[None, None, :] * J


@pytest.mark.parametrize("nb", NBS)
def test_block_inverse_stiff_newton_blocks(nb):
    M = _robertson_newton_blocks(nb)
    port = _np(block_solve.block_inverse_soa_plain(_t(M)))
    ref = np.asarray(rdv.block_inverse_soa(jnp.asarray(M), PALLAS))
    # same algorithm as the Pallas kernel: agree to 1e-10 of the scale
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=1e-10 * max(1.0, np.abs(ref).max()))
    eye = np.einsum("ijs,jks->iks", M, port)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3)[:, :, None],
                                                    eye.shape), atol=1e-8)


def test_auto_on_cpu_runs_plain_without_launching():
    d = _data(130)
    kernels.reset_counts()
    out = dv.newton_residual_soa(_t(d["z"]), _t(d["f"]), _t(d["psi"]),
                                 _t(d["gam"]), ExecPolicy(), negate=True)
    ref = dv.newton_residual_soa(_t(d["z"]), _t(d["f"]), _t(d["psi"]),
                                 _t(d["gam"]), TORCH, negate=True)
    assert torch.equal(out, ref)
    assert kernels.counts()["newton_residual"] == (0, 2)


def _op_calls(d, policy):
    t = {k: _t(v) for k, v in d.items()}
    return {
        "block_inverse_soa": lambda: dv.block_inverse_soa(t["A"], policy),
        "blockdiag_spmv_soa": lambda: dv.blockdiag_spmv_soa(t["A"], t["z"],
                                                            policy),
        "newton_residual_soa": lambda: dv.newton_residual_soa(
            t["z"], t["f"], t["psi"], t["gam"], policy),
        "masked_update_wrms_soa": lambda: dv.masked_update_wrms_soa(
            t["z"], t["f"], t["w"], t["mask"], policy),
        "history_rescale_soa": lambda: dv.history_rescale_soa(
            t["W"], t["Z"], t["mask"], policy),
        "lagrange_rescale_soa": lambda: dv.lagrange_rescale_soa(
            t["gam"], torch.full((t["gam"].shape[0],), 5, dtype=torch.int32),
            t["Z"], t["mask"], policy),
        "wrms_soa": lambda: dv.wrms_soa(t["z"], t["w"], policy),
        "block_solve_soa": lambda: dv.block_solve_soa(t["A"], t["z"], policy),
    }


@pytest.mark.parametrize("op", sorted(_op_calls(_data(7), TORCH)))
def test_cuda_backend_rejects_cpu_tensors(op):
    with pytest.raises(ValueError, match="backend 'cuda'"):
        _op_calls(_data(7), ExecPolicy(backend="cuda"))[op]()


class _OnXpu(torch.Tensor):
    """A tensor that names a device with no kernel (no data is read)."""

    @property
    def device(self):
        return torch.device("xpu", 0)


def test_wrappers_refuse_devices_without_a_kernel():
    """A wrapper takes its plain version for CPU tensors and for ``meta``
    ones (the dry run's abstract tensors, which have no data: the plain
    version gives the output's shape); a device with no kernel raises."""
    def calls(d):
        return [
            lambda: newton.newton_residual(d["z"], d["f"], d["psi"],
                                           d["gam"]),
            lambda: newton.masked_update_wrms(d["z"], d["f"], d["w"],
                                              d["mask"]),
            lambda: newton.history_rescale(d["W"], d["Z"], d["mask"]),
            lambda: newton.lagrange_rescale(d["gam"], d["gam"].int(),
                                            d["Z"], d["mask"]),
            lambda: newton.wrms_soa(d["z"], d["w"]),
            lambda: blockdiag_spmv.blockdiag_spmv_soa(d["A"], d["z"]),
            lambda: block_solve.block_inverse_soa(d["A"]),
            lambda: block_solve.block_solve_soa(d["A"], d["z"]),
        ]

    data = {k: _t(v) for k, v in _data(7).items()}
    meta = {k: v.to("meta") for k, v in data.items()}
    kernels.reset_counts()
    for call in calls(meta):
        out = call()
        for t in (out if isinstance(out, tuple) else (out,)):
            assert t.device.type == "meta"
    assert all(launched == 0 for launched, _ in kernels.counts().values())
    other = {k: v.as_subclass(_OnXpu) for k, v in data.items()}
    for call in calls(other):
        with pytest.raises(ValueError, match="no kernel for tensors on xpu"):
            call()


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        ExecPolicy(backend="pallas")
