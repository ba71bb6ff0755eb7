"""The frozen operation costs against the bound column of the port's
kernel table (bytes over 3.35 TB/s, flops over 34 TFLOP/s, float64)."""
import pytest

from portbench.harness import device, manifest

#: (op, b, systems, bound ms) as the kernel table gives them
BOUNDS = [("newton_update", 3, 2 ** 20, 0.0679),
          ("lagrange_rescale", 3, 2 ** 20, 0.0942),
          ("wrms_soa", 3, 2 ** 20, 0.0175),
          ("newton_block_inverse", 3, 2 ** 20, 0.0476),
          ("block_inverse", 32, 2 ** 16, 0.3205),
          ("blockdiag_spmv", 32, 2 ** 16, 0.1703)]


@pytest.mark.parametrize("op,n,nsys,ms", BOUNDS)
def test_the_formulas_give_the_tables_bounds(op, n, nsys, ms):
    rates = device.peak_rates(manifest.peaks(), "NVIDIA H100 80GB HBM3",
                              "float64")
    flops, nbytes = manifest.ops()[op].cost(n, nsys, 8)
    least = max(nbytes / rates["bytes_per_s"], flops / rates["flops_per_s"])
    assert 1e3 * least == pytest.approx(ms, abs=5e-5)


def test_peaks_are_the_published_ones():
    rates = device.peak_rates(manifest.peaks(), "NVIDIA H100 80GB HBM3",
                              "float64")
    assert rates["bytes_per_s"] == 3.35e12 and rates["flops_per_s"] == 34e12
    assert device.peak_rates(manifest.peaks(), "NVIDIA A100", "float64") \
        is None
