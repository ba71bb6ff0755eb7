"""A float64 witness for ``chip_smoke.py`` Q.3's gradient gate (CPU only).

Q.3 holds the card's float32 gradients of internlm2-1.8b's FULL width
cut to 2 layers to the port's CPU float32 run within a multiple of the
CPU's own float32 error, which it reads against a run with float64
weights.  That run is no float64 truth: the model casts its attention
and its loss to float32 on purpose.  This script computes the truth on
the same weights and batch as Q.3 (the port's ``Model.init`` seed 0 on
the CPU; ``synthetic_batch`` seed 3, 2 x 64): ``jax.value_and_grad`` of
the JAX package's ``Model.loss`` in float64 with those casts lifted to
float64 (its ``layers`` and ``transformer`` modules see a ``jnp`` whose
``float32`` is ``float64``, in this process only; the traced program is
checked to hold no float32 value).  It prints, leaf by leaf, the
norm-relative distance to the truth of

* the reference's float32 gradients (a second witness, independent of
  the port),
* the port's float32 gradients (the CPU side of Q.3),
* the port's run with float64 weights (Q.3's own error estimate),

and the reference's float32 against the port's float32; then the
quantities that explain the spread: the stacked weights' standard
deviation against ``1/sqrt(d_model)`` and the first layer's attention
logits (before RoPE).

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/grad_float64_witness.py \
        [--arch internlm2-1.8b] [--out witness.json]

It imports both packages, as the port's tests do, and runs only on the
CPU.  At the default cut it takes about 90 s and 22 GiB of memory
at its peak (its resident set on 8 cores).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import resource
import time
from unittest import mock

import numpy as np

#: Q.3's cut: 2 layers, batch 2 x 64 of synthetic_batch seed 3
LAYERS, BATCH, SEQ, DATA_SEED = 2, 2, 64, 3


class _WideJnp:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    def __init__(self, jnp):
        self._jnp = jnp
        self.float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(self._jnp, name)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) /
                 max(np.linalg.norm(b.ravel()), 1e-300))


def _norm(gs) -> float:
    return math.sqrt(sum(float(np.square(np.asarray(g, np.float64)).sum())
                         for g in gs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import torch
    from repro import configs as rconfigs
    from repro.models import Model as RefModel
    from repro.models import layers as rlayers
    from repro.models import transformer as rtransformer
    from repro_torch import configs
    from repro_torch.data import pipeline
    from repro_torch.models import Model, spec
    from repro_torch.train import step as tstep

    t0 = time.perf_counter()
    cfg = configs.get(args.arch).replace(n_layers=LAYERS,
                                         dtype=torch.float32)
    model = Model(cfg)
    params = model.init(0, device="cpu")
    batch = pipeline.synthetic_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
        seed=DATA_SEED), 0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    checksum = sum(float(a.double().sum()) for a in spec.tree_leaves(params))

    # the port: float32, and float64 weights (its float32 casts kept)
    _, g = tstep.value_and_grad(model.loss, params, tb)
    port32 = [t.numpy().copy() for t in spec.tree_leaves(g)]
    del g
    m64 = Model(cfg.replace(dtype=torch.float64))
    _, g = tstep.value_and_grad(
        m64.loss, spec.tree_map(torch.Tensor.double, params), tb)
    port64w = [t.numpy().copy() for t in spec.tree_leaves(g)]
    del g, m64

    # the reference on the same weights
    rcfg = rconfigs.get(args.arch).replace(n_layers=LAYERS,
                                           dtype=jnp.float32)
    rmodel = RefModel(rcfg)
    np_params = spec.tree_map(lambda t: t.numpy(), params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def ref_grads(dtype, wide=False):
        rp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    np_params)
        fn = jax.value_and_grad(rmodel.loss)
        with contextlib.ExitStack() as stack:
            if wide:
                for mod in (rlayers, rtransformer):
                    stack.enter_context(mock.patch.object(
                        mod, "jnp", _WideJnp(jnp)))
                if "f32" in str(jax.make_jaxpr(fn)(rp, jb)):
                    raise SystemExit("the float64 truth traced a float32 "
                                     "value")
            loss, gr = jax.jit(fn)(rp, jb)
            out = [np.asarray(x) for x in jax.tree_util.tree_leaves(gr)]
        names_r = [jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_leaves_with_path(gr)]
        return float(loss), out, names_r

    loss64, truth, rnames = ref_grads(jnp.float64, wide=True)
    loss64w, ref64w, _ = ref_grads(jnp.float64)
    loss32, ref32, _ = ref_grads(jnp.float32)
    assert len(truth) == len(port32) == len(ref32)
    assert all(a.shape == b.shape for a, b in zip(truth, port32))

    rows = []
    for i, name in enumerate(rnames):
        rows.append({
            "leaf": name, "truth_norm": _norm([truth[i]]),
            "ref32": _rel(ref32[i], truth[i]),
            "port32": _rel(port32[i], truth[i]),
            "port64w": _rel(port64w[i], truth[i]),
            "ref64w": _rel(ref64w[i], truth[i]),
            "port32_vs_ref32": _rel(port32[i], ref32[i]),
            "port32_vs_port64w": _rel(port32[i], port64w[i])})
    norms = {k: _norm(v) for k, v in (("truth", truth), ("ref32", ref32),
                                      ("port32", port32),
                                      ("port64w", port64w))}

    # why: the "scaled" init reads a stacked leaf's leading (layers) axis
    # as its fan-in, and the first layer's attention logits it gives
    lay = params["layers"]
    stds = {k: float(lay["attn"][k].std()) for k in ("wq", "wk", "wv", "wo")}
    with torch.no_grad():
        x = params["embed"][tb["tokens"].long()].double()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + cfg.norm_eps)
        x = x * lay["ln1"]["scale"][0].double()
        q = torch.einsum("bsd,dhk->bhsk", x, lay["attn"]["wq"][0].double())
        k = torch.einsum("bsd,dhk->bhsk", x, lay["attn"]["wk"][0].double())
        rep = cfg.n_heads // cfg.n_kv_heads
        k = k.repeat_interleave(rep, dim=1)
        s = torch.einsum("bhqk,bhsk->bhqs", q, k) / math.sqrt(cfg.hd)
        causal = torch.ones(SEQ, SEQ, dtype=torch.bool).tril()
        s = s.masked_fill(~causal, -math.inf)
        p = torch.softmax(s, -1)
        valid = s[..., causal]
        top = p.max(-1).values
    why = {"stacked_std": stds, "one_over_sqrt_d_model":
           1 / math.sqrt(cfg.d_model),
           "layer0_logit_abs_median": float(valid.abs().median()),
           "layer0_logit_abs_max": float(valid.abs().max()),
           "layer0_rows_one_hot_in_float32_share":
               float((top > 1 - 2.0 ** -24).double().mean())}
    rec = {"arch": args.arch, "layers": LAYERS, "batch": [BATCH, SEQ],
           "weights_sum": checksum,
           "loss": {"truth": loss64, "ref64w": loss64w, "ref32": loss32},
           "norms": norms, "leaves": rows, "why": why,
           "seconds": time.perf_counter() - t0,
           "peak_rss_gib": resource.getrusage(
               resource.RUSAGE_SELF).ru_maxrss / 2**20}
    print(f"{args.arch} cut to {LAYERS} layers, batch {BATCH} x {SEQ}: loss "
          f"truth {loss64!r}, reference float32 {loss32!r}; weights' sum "
          f"{checksum!r}")
    print(f"{'leaf':40s} {'|g|':>10s} {'ref32':>9s} {'port32':>9s} "
          f"{'port64w':>9s} {'ref64w':>9s} {'p32-r32':>9s} {'p32-p64w':>9s}")
    for r in rows:
        print(f"{r['leaf']:40s} {r['truth_norm']:10.4g} {r['ref32']:9.3g} "
              f"{r['port32']:9.3g} {r['port64w']:9.3g} {r['ref64w']:9.3g} "
              f"{r['port32_vs_ref32']:9.3g} {r['port32_vs_port64w']:9.3g}")
    print("global norms: " + ", ".join(f"{k} {v!r}" for k, v in
                                       norms.items()))
    print("why: " + json.dumps(why))
    print(f"{rec['seconds']:.1f} s, peak RSS {rec['peak_rss_gib']:.2f} GiB")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    main()
