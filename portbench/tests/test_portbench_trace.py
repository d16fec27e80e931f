"""The trace reader's arithmetic on hand-made traces: the device time
inside a span, and the guard's mark on a window that lost launches."""

from __future__ import annotations

import pytest

from portbench import spec, trace


def _trace(kernels, host, share=1.0):
    return trace.Trace(kernels=kernels, host=host, window_s=1.0, busy_s=0.5,
                       share=share, tries=1, lossless=share >= 0.95)


def test_busy_within_counts_only_the_span():
    # the head's kernel (0-10), the scan's two overlapping ones inside the
    # span (20-30, 25-40), one crossing its end (45-60), the tail's (70-80)
    kernels = [("head", 0.0, 10.0), ("a", 20.0, 30.0), ("b", 25.0, 40.0),
               ("c", 45.0, 60.0), ("tail", 70.0, 80.0)]
    host = [("portbench: scan", 15.0, 50.0), ("other", 0.0, 100.0)]
    busy = trace.busy_within(_trace(kernels, host), "portbench: scan")
    assert busy == pytest.approx((20.0 + 5.0) * 1e-6)
    assert trace.busy_within(_trace(kernels, host), "absent") is None


@pytest.mark.parametrize("name", ["tick_device_ms.sweep",
                                  "spd_chol_roofline_share.sweep",
                                  "device_idle_share.sweep"])
def test_a_lossy_trace_reads_nothing(name):
    read = spec.reader(name)
    obs = {"kind": "sweep", "ticks": 20, "tick_device_ms": 15.0,
           "spd_roofline_pct": 20.0}
    assert read({**obs, "trace": _trace([("k", 0.0, 1.0)], [])}) is not None
    assert read({**obs, "trace": _trace([("k", 0.0, 1.0)], [],
                                        share=0.9)}) is None
