"""The port's training gradients against the JAX package, arch by arch.

Every architecture's ``-smoke`` config in float32: the reference's
weights (``Model(cfg).init(PRNGKey(0))``) cross into the port as numpy
leaves (``interop.model_params_from_reference``), one batch (numpy
seed) goes through both, and the port's loss and gradients
(``train.step.value_and_grad``, ``torch.autograd.grad`` of
``Model.loss``) are held to ``jax.value_and_grad`` of the reference's
``Model.loss``: the loss within ``LOSS_RTOL`` relative, every gradient
leaf within ``GRAD_TOL`` of its scale (max |port - reference| <= tol *
max |reference|), where the two packages' float32 rounding allows it.

These random-weight models lose up to ~1e-3 of a gradient leaf to float32
rounding in places: whisper's encoder layer norms see the stub's
0.02-scale frames, the attention softmax and Mamba2's chunked scan cancel
terms, and xlstm's ``maximum`` stabilisers pick a branch per element on
the last bit.  So the tolerance of a leaf is the larger of ``GRAD_TOL``
and ``SPREAD_K`` times the reference's own spread there: the most its
gradient moves when every weight moves by ``ULPS`` ulps (the larger of
two random perturbations), about what the two packages' different
summation orders do to the forward pass (its logits differ by up to
3e-5 of scale, ``tests/test_torch_archs.py``).  A wrong gradient misses
by far more.

The port runs with ``remat`` on, so ``torch.utils.checkpoint`` lies on
every family's path; every leaf must get a gradient, and none may be all
zero where the reference's is not.  xlstm's mLSTM stabiliser ``exp(-m)``
overflows float32 once the running log-gate maximum ``m`` falls below
-88.7, and its backward then yields NaN (0 * inf), in the reference's
gradients as in the port's (ROADMAP §C): a leaf must hold a NaN in the
port iff it holds one in the reference, and the elements finite in both
are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as rconfigs
from repro.models import Model as RefModel
from repro_torch import configs, interop
from repro_torch.models import Model, spec
from repro_torch.train import step as tstep

LOSS_RTOL, GRAD_TOL, SPREAD_K, ULPS = 1e-5, 1e-4, 4.0, 8
B, S = 2, 16


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S), np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (B, S), np.int32)}
    if cfg.mrope:
        batch["vis_embeds"] = (0.02 * rng.standard_normal(
            (B, 4, cfg.d_model))).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = (0.02 * rng.standard_normal(
            (B, 8, cfg.d_model))).astype(np.float32)
    return batch


def _ulp_moved(tree, seed):
    """Every float32 weight moved by ``ULPS`` ulps, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a)
        to = np.where(rng.random(a.shape) < 0.5, -np.inf, np.inf).astype(
            a.dtype)
        for _ in range(ULPS):
            a = np.nextafter(a, to)
        return jnp.asarray(a)

    return jax.tree_util.tree_map(move, tree)


def _rel(a, w, ok):
    return float(np.abs(a[ok] - w[ok]).max()) / float(np.abs(w[ok]).max())


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_gradients_match_reference(arch):
    name = f"{arch}-smoke"
    cfg = configs.get(name).replace(dtype=torch.float32, remat=True)
    rcfg = rconfigs.get(name).replace(dtype=jnp.float32)
    rmodel, model = RefModel(rcfg), Model(cfg)
    rparams = jax.jit(rmodel.init)(jax.random.PRNGKey(0))
    params = interop.model_params_from_reference(
        jax.tree_util.tree_map(np.asarray, rparams), model, device="cpu")
    batch = _batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(rmodel.loss))
    rloss, rgrads = grad_fn(rparams, jb)
    moved = [jax.tree_util.tree_leaves(grad_fn(_ulp_moved(rparams, s), jb)[1])
             for s in (1, 2)]
    loss, grads = tstep.value_and_grad(
        model.loss, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(loss) - float(rloss)) <= LOSS_RTOL * abs(float(rloss))
    got = spec.tree_leaves(grads)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(rgrads)]
    assert len(got) == len(want)
    for i, ((path, _), g, w) in enumerate(zip(
            jax.tree_util.tree_leaves_with_path(rgrads), got, want)):
        where = f"{arch} {jax.tree_util.keystr(path)}"
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, where
        g = g.numpy()
        assert np.isnan(g).any() == np.isnan(w).any(), where
        ok = ~(np.isnan(g) | np.isnan(w))
        if not ok.any() or float(np.abs(w[ok]).max()) == 0:
            assert not ok.any() or float(np.abs(g[ok]).max()) == 0, where
            continue
        spread = max(_rel(np.asarray(m[i]), w, ok & ~np.isnan(m[i]))
                     for m in moved)
        tol = max(GRAD_TOL, SPREAD_K * spread)
        err = _rel(g, w, ok)
        assert err <= tol, (f"{where}: max diff {err:.3g} of scale, the "
                            f"reference's one-ulp spread {spread:.3g}")
        assert float(np.abs(g[ok]).max()) > 0, where
