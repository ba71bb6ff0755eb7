"""kernel-contract: a kernel and its plain version are interchangeable,
and every kernel launch fits the card.

Three parts, over the context's contract grid (the reference's,
``repro/analysis/lint.py:274-310``, and the port's own ops'):

(a) for each op and each signature, the inputs
    :func:`repro_torch.core.autotune.args_for` builds from it give back
    that signature under :func:`repro_torch.analysis.opcost.signature`,
    so the tuner's keys and ``"auto"`` dispatch's keys agree by
    construction;
(b) where a card is present, the kernel wrapper and the plain version
    of each op, run on those inputs on the card, return the same tree of
    shapes and dtypes.  On the CPU only (a) and (c) run: a CPU tensor
    takes the plain version under both, so (b) would compare it with
    itself;
(c) the launch half, in place of the reference's VMEM check: the
    dynamic shared memory the warp Gauss-Jordan bodies request
    (``kernels/csrc/block_solve.cu`` ``gj_smem_bytes``) and the row-form
    SpMV's static x tile (``kernels/csrc/blockdiag_spmv.cu``) fit the
    roofline row's per-block limit (and the 48 KiB of a static array)
    at every b the wrappers route to them, in both dtypes; the blocks'
    thread counts fit its thread limit; and the Python side's statement
    of those sizes (``kernels.block_solve.warp_smem_bytes``,
    ``kernels.blockdiag_spmv.row_tile_bytes``, ``_build.REPRO_THREADS``,
    ``kernels.newton.RESIDUAL_MAX_N``) still names the sources'
    ``#define``s.
"""
import re

from .. import lint

#: the most static shared memory one block may hold (CUDA, every
#: architecture): a ``__shared__`` array above it does not compile
STATIC_SMEM_BYTES = 48 * 1024


def _spec(tree):
    """[(shape, dtype)] of an output tree of tensors, tuples, lists."""
    if isinstance(tree, (tuple, list)):
        return [s for t in tree for s in _spec(t)]
    return [(tuple(tree.shape), str(tree.dtype))]


def _defines(path):
    """``{NAME: int}`` of a source's integer ``#define``s."""
    found = {}
    for m in re.finditer(r"^#define\s+(\w+)\s+(\d+)\b", path.read_text(),
                         re.M):
        found[m.group(1)] = int(m.group(2))
    return found


def _check_sigs(ctx, out):
    import torch
    from ...core import autotune
    from .. import opcost
    gen = torch.Generator().manual_seed(0)
    card = torch.device("cuda") if ctx.cuda else None
    for op in sorted(ctx.op_table):
        sigs = ctx.contract_sigs.get(op)
        if not sigs:
            out.append(lint.Violation(
                "kernel-contract", op, "op has no contract signature grid "
                "(add it to lint.default_contract_sigs)"))
            continue
        impls = ctx.op_table[op]
        for sig in sigs:
            where = sig.key()
            try:
                got = opcost.signature(op, autotune.args_for(sig, "cpu", gen))
            except Exception as e:          # an op its builder cannot make
                out.append(lint.Violation(
                    "kernel-contract", where, f"inputs from the signature "
                    f"fail: {type(e).__name__}: {str(e).splitlines()[0]}"))
                continue
            if got != sig:
                out.append(lint.Violation(
                    "kernel-contract", where, f"inputs built from the "
                    f"signature give back {got.key()}"))
                continue
            if card is None:
                continue
            args = autotune.args_for(sig, card)
            try:
                plain, kern = _spec(impls["torch"](*args)), \
                    _spec(impls["cuda"](*args))
            except Exception as e:
                out.append(lint.Violation(
                    "kernel-contract", where, f"a run on the card fails: "
                    f"{type(e).__name__}: {str(e).splitlines()[0]}"))
                continue
            if plain != kern:
                out.append(lint.Violation(
                    "kernel-contract", where, f"output mismatch: plain "
                    f"{plain}, kernel {kern}"))


def _check_launches(ctx, out):
    from ...kernels import _build, block_solve, blockdiag_spmv, newton
    dev = ctx.device
    csrc = _build.CSRC
    stated = {
        "block_solve.cu": {"GJ_WARPS": block_solve.GJ_WARPS,
                           "GJ_PIVOT_SLOTS": block_solve.GJ_PIVOT_SLOTS,
                           "GJ_WARP_MAX_B": block_solve.WARP_MAX_B},
        "blockdiag_spmv.cu": {"SPMV_WARPS": blockdiag_spmv.SPMV_WARPS,
                              "SPMV_SYSTEMS": blockdiag_spmv.SPMV_SYSTEMS,
                              "SPMV_MAX_B": blockdiag_spmv.SPMV_MAX_B},
        "newton.cu": {"RESIDUAL_MAX_N": newton.RESIDUAL_MAX_N},
        "common.cuh": {"REPRO_THREADS": _build.REPRO_THREADS},
    }
    for fname, names in stated.items():
        try:
            found = _defines(csrc / fname)
        except OSError as e:
            out.append(lint.Violation("kernel-contract", f"launch:{fname}",
                                      f"unreadable source: {e}"))
            continue
        for name, value in names.items():
            if found.get(name) != value:
                out.append(lint.Violation(
                    "kernel-contract", f"launch:{fname}:{name}",
                    f"the Python side states {name} = {value}, the source "
                    f"{found.get(name)}"))
    for what, threads in (("gj_warp", 32 * block_solve.GJ_WARPS),
                          ("spmv_rows", 32 * blockdiag_spmv.SPMV_WARPS),
                          ("one_thread_a_system", _build.REPRO_THREADS)):
        if threads > dev.max_block_threads:
            out.append(lint.Violation(
                "kernel-contract", f"launch:{what}", f"{threads} threads a "
                f"block, {dev.name} allows {dev.max_block_threads}"))
    for itemsize, dtype in ((4, "float32"), (8, "float64")):
        for b in range(block_solve.UNROLL_MAX_B + 1,
                       block_solve.WARP_MAX_B + 1):
            need = block_solve.warp_smem_bytes(b, itemsize)
            if need > dev.smem_optin_bytes:
                out.append(lint.Violation(
                    "kernel-contract", f"launch:gj_warp:b={b}:{dtype}",
                    f"requests {need} B of dynamic shared memory, "
                    f"{dev.name} allows {dev.smem_optin_bytes} B a block"))
            tile = blockdiag_spmv.row_tile_bytes(b, itemsize)
            limit = min(STATIC_SMEM_BYTES, dev.smem_optin_bytes)
            if b <= blockdiag_spmv.SPMV_MAX_B and tile > limit:
                out.append(lint.Violation(
                    "kernel-contract", f"launch:spmv_rows:b={b}:{dtype}",
                    f"its x tile takes {tile} B of static shared memory, "
                    f"{limit} B fit a block"))


@lint.register(
    "kernel-contract",
    "inputs built from a signature give it back; on a card kernel and "
    "plain version agree in shapes and dtypes; launches fit the card")
def check(ctx):
    out = []
    _check_sigs(ctx, out)
    _check_launches(ctx, out)
    return out
