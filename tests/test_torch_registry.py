"""The port's op registry and per-op policy pins against the JAX
package's (``repro.core.dispatch`` ``OP_TABLE``, ``ExecPolicy.
op_overrides``), on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import dispatch as rdv
from repro.core import policies as rpol
from repro.core import batched as ref_batched
from repro.core.arkode import ODEOptions as RefOptions
from repro_torch.core import batched, dispatch as dv, policies
from repro_torch.core.arkode import ODEOptions
from repro_torch.core.policies import ExecPolicy
from repro_torch.kernels import blockdiag_spmv, newton

PORT_OWN = {"lagrange_rescale_soa", "newton_residual_lsolve_soa",
            "newton_update_soa", "newton_block_inverse_soa"}


def test_op_names_are_the_references_and_the_ports_own():
    assert dv.op_names() == rdv.op_names() | PORT_OWN
    assert list(dv.OP_TABLE)[:len(rdv.OP_TABLE)] == list(rdv.OP_TABLE)


@pytest.mark.parametrize("op", sorted(rdv.OP_TABLE))
def test_each_op_takes_the_references_positional_arguments(op):
    want = rdv._positional_arity(rdv.OP_TABLE[op]["jnp"])
    for backend in ("torch", "cuda"):
        assert dv._positional_arity(dv.OP_TABLE[op][backend]) == want


def test_validate_op_table_reports_every_problem_at_once():
    dv.validate_op_table()                  # the real table (also at import)
    good = dv.OP_TABLE["dot"]

    def two(x, y):
        return x

    def three(x, y, z):
        return x

    table = {"dot": good,
             "half": {"torch": two},
             "stray": {"torch": two, "cuda": two, "pallas": two},
             "arity": {"torch": two, "cuda": three},
             "called": {"torch": two, "cuda": 2},
             "shape": [two, two]}
    with pytest.raises(ValueError) as err:
        dv.validate_op_table(table)
    msg = str(err.value)
    assert "(5 problems)" in msg
    for part in ("half: missing 'cuda' implementation",
                 "stray: unknown backend keys ['pallas']",
                 "arity: arity mismatch",
                 "called: 'cuda' implementation is not callable",
                 "shape: entry is list"):
        assert part in msg
    # the reference's validator finds the same kinds of fault
    def ref_two(x, y, *, policy=None):
        return x

    with pytest.raises(ValueError, match=r"\(1 problem\)"):
        rdv.validate_op_table({"half": {"jnp": ref_two}})


def test_op_overrides_are_validated_against_the_table():
    with pytest.raises(ValueError) as err:
        ExecPolicy(op_overrides=(("dott", "torch"), ("dot", "pallas")))
    msg = str(err.value)
    assert "unknown dispatch op 'dott'" in msg
    assert "unknown backend 'pallas' for op 'dot'" in msg
    for op in dv.op_names():
        assert op in msg
    with pytest.raises(ValueError, match="unknown dispatch op 'dott'"):
        rpol.ExecPolicy(op_overrides=(("dott", "jnp"),))
    with pytest.raises(ValueError, match="unknown backend"):
        ExecPolicy(backend="pallas")


def test_override_and_backend_for_as_the_reference():
    p = ExecPolicy().override(dot="torch", wrms_ss="cuda")
    r = rpol.AUTO.override(dot="jnp", wrms_ss="pallas")
    assert p.op_overrides == (("dot", "torch"), ("wrms_ss", "cuda"))
    assert [k for k, _ in p.op_overrides] == [k for k, _ in r.op_overrides]
    assert p.backend_for("dot") == "torch" and p.backend_for("wrms_ss") == "cuda"
    assert p.backend_for("linear_sum") == "auto"
    q = p.override(dot="auto")                 # a later pin replaces
    assert q.backend_for("dot") == "auto" and q.backend_for("wrms_ss") == "cuda"
    assert p.backend_for("dot") == "torch"     # frozen: p unchanged
    assert hash(q) == hash(ExecPolicy(op_overrides=q.op_overrides))
    assert r.override(dot="auto").backend_for("dot") == "auto"


@pytest.mark.parametrize("op", sorted(dv.op_names()))
def test_dispatch_returns_the_pinned_implementation(op):
    impls = dv.OP_TABLE[op]
    other = next(o for o in sorted(dv.op_names()) if o != op)
    # "auto" is the op's recording callable (core/autotune.py), built once
    auto = {o: dv.dispatch(o, ExecPolicy()) for o in (op, other)}
    assert auto[op] not in (impls["torch"], impls["cuda"])
    for policy, want, want_other in (
            (ExecPolicy().override(**{op: "torch"}), "torch", "auto"),
            (ExecPolicy(backend="torch").override(**{op: "auto"}), "auto",
             "torch"),
            (ExecPolicy(), "auto", "auto"),
            (None, "auto", "auto")):
        for o, w in ((op, want), (other, want_other)):
            assert dv.dispatch(o, policy) is \
                (auto[o] if w == "auto" else dv.OP_TABLE[o][w])
    # "cuda" is the kernel wrapper behind a device check, built once
    pinned = ExecPolicy().override(**{op: "cuda"})
    fn = dv.dispatch(op, pinned)
    assert fn is not impls["cuda"] and dv.dispatch(op, pinned) is fn
    with pytest.raises(ValueError, match="unknown dispatch op 'nope'"):
        dv.dispatch("nope")


def test_a_cuda_pin_refuses_cpu_tensors_for_its_op_only():
    x = torch.ones(5, dtype=torch.float64)
    pinned = ExecPolicy().override(dot="cuda")
    with pytest.raises(ValueError, match="dot: backend 'cuda' needs CUDA"):
        dv.dot(x, x, pinned)
    assert float(dv.wrms_norm(x, x, pinned)) == 1.0


def test_policies_docstring_embeds_the_rendered_table():
    table = dv.render_op_table()
    assert table in policies.__doc__
    rows = table.splitlines()[3:-1]
    assert [r.split()[0] for r in rows] == list(dv.OP_TABLE)
    md = dv.render_op_table("md").splitlines()
    assert len(md) == 2 + len(dv.OP_TABLE)
    assert md[0].startswith("| op ")
    # the reference's table is embedded the same way
    assert rdv.render_op_table() in rpol.__doc__


def _np(t):
    return t.detach().cpu().numpy()


def _op_inputs(op, rng):
    """Seeded inputs of ``op`` as numpy arrays: (args, kwargs)."""
    n, nb, b = 3, 130, 3
    x, y, w = (rng.normal(size=257) for _ in range(3))
    w = np.abs(w) + 0.1
    if op in ("linear_sum",):
        return (0.5, x, -2.0, y), {}
    if op == "axpy":
        return (1.5, x, y), {}
    if op == "linear_combination":
        return ((0.5, -1.0, 2.0), (x, y, w)), {}
    if op == "scale_add_multi":
        return ((0.5, -1.0), x, (y, w)), {}
    if op in ("dot", "wrms_norm", "wrms_ss"):
        return (x, w), {}
    if op == "wrms_norm_mask":
        return (x, w, (rng.uniform(size=257) > 0.3).astype(np.float64)), {}
    if op == "dot_prod_multi":
        return (x, (y, w)), {}
    A = rng.normal(size=(b, b, nb)) + b * np.eye(b)[:, :, None]
    if op == "block_solve_soa":
        return (A, rng.normal(size=(b, nb))), {}
    if op == "block_inverse_soa":
        return (A,), {}
    if op == "blockdiag_spmv_soa":
        return (A, rng.normal(size=(b, nb))), {}
    z, f, psi = (rng.normal(size=(n, nb)) for _ in range(3))
    if op == "newton_residual_soa":
        return (z, f, psi, np.abs(rng.normal(size=nb))), {"negate": True}
    if op == "masked_update_wrms_soa":
        return (z, f, np.abs(psi) + 0.1, rng.uniform(size=nb) > 0.4), {}
    if op == "history_rescale_soa":
        return (rng.normal(size=(6, 6, nb)), rng.normal(size=(6, n, nb)),
                rng.uniform(size=nb) > 0.4), {}
    if op == "wrms_soa":
        return (z, np.abs(f) + 0.1), {}
    return None


def _convert(a, to):
    if isinstance(a, np.ndarray):
        return to(a)
    if isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        return tuple(to(v) for v in a)
    return a


@pytest.mark.parametrize("op", sorted(
    o for o in rdv.OP_TABLE if o not in
    ("csr_spmv", "bsr_spmv_soa", "bsr_block_jacobi_inverse_soa")))
def test_registry_implementations_match_the_reference(op):
    """Both of the port's implementations of each op (on the CPU the
    kernel wrapper runs its plain version) against the reference's jnp
    implementation of the op, on numpy-seeded inputs, within 1e-12."""
    args, kw = _op_inputs(op, np.random.default_rng(len(op)))
    want = rdv.dispatch(op, rpol.XLA_FUSED)(
        *(_convert(a, jnp.asarray) for a in args), **kw)
    t_args = [_convert(a, torch.from_numpy) for a in args]
    for backend in ("torch", "auto"):
        got = dv.dispatch(op, ExecPolicy().override(**{op: backend}))(
            *t_args, **kw)
        gl = got if isinstance(got, (tuple, list)) else (got,)
        wl = want if isinstance(want, (tuple, list)) else (want,)
        assert len(gl) == len(wl)
        for g, r in zip(gl, wl):
            np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12,
                                       atol=1e-12, err_msg=backend)


NSYS, N = 16, 3
RATES = np.linspace(10.0, 80.0, NSYS)


def test_a_pin_reaches_the_bdf_loop(monkeypatch):
    """``override(blockdiag_spmv_soa="torch")`` sends the BDF lsolve to
    the plain version and nothing else: the SpMV's kernel wrapper is
    never entered, the other wrappers are (the residual's and the
    masked update's alone, not the fused Newton iteration that the
    unpinned run enters instead); y equals the unpinned run's and lies
    within 10*(rtol*|y|+atol) of the reference's."""
    entered = []
    for mod, name in ((blockdiag_spmv, "blockdiag_spmv_soa"),
                      (newton, "newton_residual"),
                      (newton, "newton_residual_lsolve"),
                      (newton, "newton_update"),
                      (newton, "masked_update_wrms"),
                      (newton, "lagrange_rescale"), (newton, "wrms_soa")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **k):
            entered.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    rates = torch.from_numpy(RATES)

    def f(t, y):
        return -rates[:, None] * (y - torch.cos(t)[:, None])

    def jac(t, y):
        return (-rates[:, None, None] * torch.eye(N, dtype=y.dtype)) \
            .expand(NSYS, N, N).contiguous()

    y0 = torch.zeros((NSYS, N), dtype=torch.float64)
    opts = ODEOptions(rtol=1e-6, atol=1e-10)
    pinned = ExecPolicy(device="cpu").override(blockdiag_spmv_soa="torch")
    y, st = batched.ensemble_bdf_integrate(f, jac, y0, 0.0, 2.0, opts=opts,
                                           policy=pinned)
    assert {"blockdiag_spmv_soa", "newton_residual_lsolve",
            "newton_update"}.isdisjoint(entered)
    assert {"newton_residual", "masked_update_wrms", "lagrange_rescale",
            "wrms_soa"} <= set(entered)
    entered.clear()
    y1, st1 = batched.ensemble_bdf_integrate(f, jac, y0, 0.0, 2.0, opts=opts)
    assert "newton_update" in entered
    assert {"blockdiag_spmv_soa", "newton_residual", "newton_residual_lsolve",
            "masked_update_wrms"}.isdisjoint(entered)
    assert torch.equal(y, y1) and torch.equal(st.retcodes, st1.retcodes)
    r = jnp.asarray(RATES)
    y_ref, st_ref = ref_batched.ensemble_bdf_integrate(
        lambda t, y: -r[:, None] * (y - jnp.cos(t)[:, None]),
        lambda t, y: jnp.broadcast_to(-r[:, None, None] * jnp.eye(N),
                                      (NSYS, N, N)),
        jnp.zeros((NSYS, N)), 0.0, 2.0, opts=RefOptions(rtol=1e-6, atol=1e-10),
        policy=rpol.XLA_FUSED.override(blockdiag_spmv_soa="jnp"))
    y_ref = np.asarray(y_ref)
    assert np.all(np.abs(_np(y) - y_ref) <= 10 * (1e-6 * np.abs(y_ref) + 1e-10))
    np.testing.assert_array_equal(_np(st.success), np.asarray(st_ref.success))
