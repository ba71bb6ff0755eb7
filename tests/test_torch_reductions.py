"""The one-launch reductions' partition and summation order.

``vecops.dot``, ``wrms_ss`` and ``wrms_mask_ss`` (PERF.md rows 16, 14,
15) launch one CUDA kernel over the plan ``vecops.reduction_plan(n,
dtype)``.  On the CPU these tests hold the plan (every element in
exactly one chunk of whole 16-byte units, at most ``RED_MAX_BLOCKS``
blocks, nothing read from the device) and :func:`kernel_order_sum`, a
plain PyTorch statement of the kernel's summation order, against the
plain versions.  On the card (marked ``cuda``, skipped without one) the
kernels must equal :func:`kernel_order_sum` bit for bit, wherever their
inputs lie.  No JAX here: with ``--noconftest`` the file runs where only
PyTorch and the CUDA toolkit are installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_reductions.py
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.kernels import vecops

NS = [1, 2, 3, 130, 8193, 1 << 21, 3 * (1 << 20) + 5]
DTYPES = [torch.float64, torch.float32]
THREADS = 256
CSRC = Path(vecops.__file__).resolve().parent / "csrc" / "vecops.cu"


def _block_sum(v):
    """The kernel's ``block_sum`` over the last axis (256 thread sums):
    each warp's shuffle-down tree, then the eight warp sums in order."""
    w = v.reshape(*v.shape[:-1], THREADS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        w = w[..., :off] + w[..., off:2 * off]
    w = w[..., 0]
    acc = w[..., 0]
    for k in range(1, THREADS // 32):
        acc = acc + w[..., k]
    return acc


def _strided_sums(t):
    """Thread j of a block (last axis of length L) sums elements j,
    j + 256, ... in increasing order, from 0: -> (..., 256)."""
    rows = -(-t.shape[-1] // THREADS)
    pad = rows * THREADS - t.shape[-1]
    t = torch.cat([t, t.new_zeros(*t.shape[:-1], pad)], -1)
    t = t.reshape(*t.shape[:-1], rows, THREADS)
    acc = t.new_zeros(*t.shape[:-2], THREADS)
    for r in range(rows):
        acc = acc + t[..., r, :]
    return acc


def kernel_order_sum(terms, blocks, chunk):
    """The sum of the flat ``terms`` in the CUDA reduction's order over
    the plan ``(blocks, chunk)``: block b's thread sums over its chunk
    (zeros past n change no bit: a sum that starts at +0 is never -0),
    its ``block_sum``, then the last block's thread-strided sum of the
    partials in index order and its ``block_sum``; float32 terms summed
    in float64 (``vecops.ACC_DTYPE``) and the result rounded once."""
    flat = terms.reshape(-1)
    flat = flat.to(vecops.ACC_DTYPE.get(flat.dtype, flat.dtype))
    flat = torch.cat([flat, flat.new_zeros(blocks * chunk - flat.numel())])
    partial = _block_sum(_strided_sums(flat.reshape(blocks, chunk)))
    return _block_sum(_strided_sums(partial)).to(terms.dtype)


def _terms(op, x, w, m):
    if op == "dot":
        return x * w
    u = x * w
    if op == "wrms_mask_ss":
        u = u * m
    return u * u


def _inputs(n, dtype, device="cpu"):
    rng = np.random.default_rng(n)
    d = {"x": rng.normal(size=n), "w": np.abs(rng.normal(size=n)) + 0.1,
         "m": (rng.uniform(size=n) > 0.3).astype(float)}
    return {k: torch.from_numpy(v).to(device, dtype) for k, v in d.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
def test_plan_covers_every_element_once(n, dtype):
    blocks, chunk = vecops.reduction_plan(n, dtype)
    assert 1 <= blocks <= vecops.RED_MAX_BLOCKS
    assert (chunk * dtype.itemsize) % 16 == 0
    # every block but the last gets exactly chunk elements, the last the
    # rest (at least one): the chunks tile [0, n)
    starts = [b * chunk for b in range(blocks)]
    ends = [min(s + chunk, n) for s in starts]
    assert starts[0] == 0 and ends[-1] == n
    assert all(e > s for s, e in zip(starts, ends))
    assert all(e - s == chunk for s, e in zip(starts[:-1], ends[:-1]))
    assert all(e == s for e, s in zip(ends[:-1], starts[1:]))
    covered = np.zeros(n, dtype=int)
    for s, e in zip(starts, ends):
        covered[s:e] += 1
    assert (covered == 1).all()


def test_plan_fewer_blocks_for_short_vectors():
    for dtype in DTYPES:
        assert vecops.reduction_plan(1, dtype)[0] == 1
        assert vecops.reduction_plan(130, dtype)[0] == 1
        assert 1 < vecops.reduction_plan(8193, dtype)[0] < \
            vecops.RED_MAX_BLOCKS
        assert vecops.reduction_plan(1 << 21, dtype)[0] == \
            vecops.RED_MAX_BLOCKS


def test_plan_limits_agree_with_the_cuda_source():
    src = CSRC.read_text()
    assert int(re.search(r"#define RED_MAX_BLOCKS (\d+)", src).group(1)) == \
        vecops.RED_MAX_BLOCKS


def test_plan_is_the_same_for_a_cpu_and_a_cuda_device(monkeypatch):
    """The plan reads nothing of a device: with every query of the card
    refused it is what it was, so a CPU tensor and a CUDA tensor of one
    length and dtype (on any card) get one partition."""
    want = {(n, dt): vecops.reduction_plan(n, dt) for n in NS
            for dt in DTYPES}

    def refuse(*a, **k):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "current_device",
                 "get_device_properties", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    vecops.reduction_plan.cache_clear()
    for (n, dt), plan in want.items():
        assert vecops.reduction_plan(n, dt) == plan


@pytest.mark.parametrize("op", ["dot", "wrms_ss", "wrms_mask_ss"])
@pytest.mark.parametrize("n", NS)
def test_kernel_order_matches_the_plain_versions(n, op):
    """The kernel's order of summation, stated in PyTorch, agrees with
    the plain version within the tolerance the card tests hold the
    kernel to: 1e-10 of the sum of |terms| (float64)."""
    d = _inputs(n, torch.float64)
    got = kernel_order_sum(_terms(op, d["x"], d["w"], d["m"]),
                           *vecops.reduction_plan(n, torch.float64))
    plain = {"dot": lambda: vecops.dot_plain(d["x"], d["w"]),
             "wrms_ss": lambda: vecops.wrms_ss_plain(d["x"], d["w"]),
             "wrms_mask_ss": lambda: vecops.wrms_mask_ss_plain(
                 d["x"], d["w"], d["m"])}[op]()
    scale = _terms(op, d["x"], d["w"], d["m"]).abs().sum().item()
    assert got.shape == ()
    assert abs(got.item() - plain.item()) <= 1e-10 * scale


def test_kernel_order_sums_a_block_as_the_kernel_does():
    """``_block_sum`` against the kernel's steps written out lane by
    lane: ``__shfl_down_sync`` (a lane past 31 reads its own value),
    then thread 0 adds the warp sums in order.  Random float32 values
    with a wide spread of magnitudes, so another order moves bits."""
    rng = np.random.default_rng(7)
    v = (rng.normal(size=THREADS) * 10.0 ** rng.uniform(-6, 6, THREADS))
    v = torch.from_numpy(v).to(torch.float32)
    warp_sums = []
    for k in range(THREADS // 32):
        lanes = [v[32 * k + l] for l in range(32)]
        for off in (16, 8, 4, 2, 1):
            lanes = [lanes[l] + (lanes[l + off] if l + off < 32
                                 else lanes[l]) for l in range(32)]
        warp_sums.append(lanes[0])
    want = warp_sums[0]
    for s in warp_sums[1:]:
        want = want + s
    assert torch.equal(_block_sum(v), want)
    seq = v[0]
    for t in v[1:]:
        seq = seq + t
    assert not torch.equal(seq, want)     # the order shows in the bits


# ---------------------------------------------------------------------------
# On the card: the kernels equal the stated order, bit for bit
# ---------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _at_offset(t, off):
    """t's values in a fresh buffer, starting ``off`` elements into it."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[off:off + t.numel()]
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("op", ["dot", "wrms_ss", "wrms_mask_ss"])
def test_kernels_sum_in_the_stated_order_on_card(op, n, dtype):
    _need_card()
    d = _inputs(n, dtype, "cuda")
    want = kernel_order_sum(_terms(op, d["x"], d["w"], d["m"]),
                            *vecops.reduction_plan(n, dtype))
    fn = getattr(vecops, op)
    names = ("x", "w", "m") if op == "wrms_mask_ss" else ("x", "w")
    step = 16 // dtype.itemsize
    # each input at its own offset from a 16-byte boundary
    for shift in range(step):
        args = [_at_offset(d[k], (shift + i) % step)
                for i, k in enumerate(names)]
        kernels.reset_counts()
        got = fn(*args)
        assert kernels.counts()[op][0] == 1
        assert torch.equal(got, want), (shift, got.item(), want.item())
