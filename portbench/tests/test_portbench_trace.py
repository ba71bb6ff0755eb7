"""The traced run's reduction on synthetic intervals: the idle share,
device time by layer, the roofline share and the labelled idle gaps."""
import pytest

from portbench.harness import trace

E = trace.Event
SPAN = trace.CALL_SPAN
PEAK = {"bytes_per_s": 1e12, "flops_per_s": 1e12}


class _Op:
    SYMBOLS = ("fast_kernel",)

    @staticmethod
    def cost(n, nsys, itemsize):
        return 0, n * nsys * itemsize       # 1e-6 s at (1, 1e6, 1)


def test_merge():
    assert trace.merge([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]
    assert trace.merge([]) == []


DEV = [E("void fast_kernel<double, 3>(double*)", 1.0, 3.0),
       E("void at::native::elementwise_kernel<128>(int)", 10.0, 30.0),
       E("void lonely_kernel(float*)", 70.0, 80.0),
       E("void fast_kernel<double, 3>(double*)", 160.0, 162.0)]
SPANS = [(0.0, 100.0), (150.0, 200.0)]


def _summary(dev, spans=SPANS, host=None):
    return trace.summarize(dev, spans, {"fast_kernel", "lonely_kernel"},
                           {"fast": _Op}, (1, 10 ** 6, 1), PEAK, host=host)


def test_layers_roofline_and_idle_share():
    s = _summary(DEV)
    assert s.calls == 2 and s.window_s == pytest.approx(200e-6)
    assert s.busy_s == pytest.approx(34e-6)
    assert 100 * (1 - s.busy_s / s.window_s) == pytest.approx(83.0)
    assert s.plain_s == pytest.approx(20e-6)
    assert s.kernel_s == pytest.approx(14e-6)
    # two launches of 2 us that need 1 us each; lonely_kernel has no op
    assert s.roofline_share == pytest.approx(50.0)
    assert s.by_op == {"fast": [2, pytest.approx(4e-6),
                                pytest.approx(2e-6)]}
    assert s.unmatched == ("lonely_kernel",)
    assert s.device_ops[0] == ["at::native::elementwise_kernel<128>",
                               pytest.approx(20e-6)]
    assert s.idle_gaps == []


def test_gaps_are_labelled_by_the_host_stage():
    cpu = [E(SPAN, 0.0, 100.0, 1), E(SPAN, 150.0, 200.0, 1),
           E("aten::where", 40.0, 60.0, 1), E("aten::mul", 1.0, 99.0, 2)]
    gaps = dict(_summary(DEV, host=(cpu, DEV)).idle_gaps)
    # a gap goes whole to what the main thread did at its midpoint
    assert gaps["between calls"] == pytest.approx(80e-6)
    assert gaps["aten::where"] == pytest.approx(40e-6)
    assert gaps["host python"] == pytest.approx(46e-6)
    assert sum(gaps.values()) == pytest.approx(166e-6)
    assert trace.idle_gaps([], DEV) == []


def test_a_profile_without_device_time_or_on_another_clock_fails():
    with pytest.raises(RuntimeError, match="no device time"):
        _summary([])
    with pytest.raises(RuntimeError, match="no call"):
        _summary(DEV, spans=[])
    # the calls' marks an hour away from the device's events
    with pytest.raises(RuntimeError, match="clock"):
        _summary(DEV + [E("void fast_kernel<double>()", 3.6e9, 3.6e9 + 50)])


def test_a_symbol_matches_only_whole_names():
    pat = trace.symbol_pattern({"wrms_soa_kernel", "wrms_kernel"})
    m = pat.search("void wrms_soa_kernel<double>(double*)")
    assert m.group(m.lastindex) == "wrms_soa_kernel"
    m = pat.search("_Z15wrms_soa_kernelIdEvPd")
    assert m.group(m.lastindex) == "wrms_soa_kernel"
    assert not pat.search("void masked_update_wrms_kernel<double>()")
    assert not pat.search("void wrms_kernel2<double>()")
    assert not trace.symbol_pattern(set()).search("anything")


def test_the_clock_offset_comes_from_the_host_stage():
    cpu = [E("aten::mul", 5.0, 6.0), E(SPAN, 1005.0, 1100.0)]
    assert trace.clock_offset(cpu, (5.0, 99.0)) == pytest.approx(1000.0)
    assert trace.clock_offset(cpu, None) == 0.0
    assert trace.clock_offset([], (5.0, 99.0)) == 0.0
