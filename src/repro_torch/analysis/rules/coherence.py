"""table-coherence: one op set, named alike everywhere.

The dispatch op table is the source of truth.  The cost model's
signature extractors and cost models must cover exactly its ops (a
missing entry fails ``"auto"`` at its first call, an extra one is dead
modelling), the op notes must describe every op, every autotune cache
of the port (``$REPRO_TORCH_AUTOTUNE_DIR`` or ``.autotune_torch/``;
never the reference's ``.autotune/``) may key only its ops, and the
policies module's docstring and README's port section must embed the
current render of the table verbatim (``python -m
repro_torch.core.dispatch`` prints the rst one).
"""
import json

from .. import lint


def _diff(where, label, ops, keys, out, extra_only=False):
    if not extra_only:
        for m in sorted(ops - keys):
            out.append(lint.Violation("table-coherence", where,
                                      f"{label} is missing op {m!r}"))
    for e in sorted(keys - ops):
        out.append(lint.Violation(
            "table-coherence", where,
            f"{label} names an op {e!r} that is not in the op table"))


@lint.register(
    "table-coherence",
    "OP_TABLE, the opcost registries, OP_NOTES, the port's autotune "
    "cache keys and the rendered op matrices name one op set")
def check(ctx):
    from .. import opcost
    from ...core import dispatch, policies

    ops = set(ctx.op_table)
    out = []
    _diff("opcost", "opcost.SIG_EXTRACTORS", ops, set(opcost.SIG_EXTRACTORS),
          out)
    _diff("opcost", "opcost.COST_MODELS", ops, set(opcost.COST_MODELS), out)
    _diff("dispatch", "dispatch.OP_NOTES", ops, set(dispatch.OP_NOTES), out)

    # a cache may be partial (entries are measured on demand) but never
    # keys an op outside the table
    if ctx.cache_dir.is_dir():
        for path in sorted(ctx.cache_dir.glob("*.json")):
            where = f"autotune:{path.name}"
            try:
                payload = json.loads(path.read_text())
                cache_ops = {e.get("sig", {}).get("op")
                             for e in payload.get("entries", {}).values()}
            except (OSError, ValueError, AttributeError) as e:
                out.append(lint.Violation("table-coherence", where,
                                          f"unreadable cache file: {e}"))
                continue
            cache_ops.discard(None)
            _diff(where, f"cache {path.name}", ops, cache_ops, out,
                  extra_only=True)

    if dispatch.render_op_table("rst") not in (policies.__doc__ or ""):
        out.append(lint.Violation(
            "table-coherence", "policies-docstring",
            "the policies module's docstring does not embed the current "
            "rst op matrix (python -m repro_torch.core.dispatch prints "
            "it)"))
    readme = ctx.repo_root / "README.md"
    if not readme.is_file() or \
            dispatch.render_op_table("md") not in readme.read_text():
        out.append(lint.Violation(
            "table-coherence", "README",
            "README.md does not embed the current markdown op matrix "
            "(dispatch.render_op_table('md'))"))
    return out
