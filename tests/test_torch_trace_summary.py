"""chip_smoke.trace_summary: the profile numbers chip_smoke.py reports,
computed from a trace's raw events as torch.profiler links them (a device
event to the host op whose correlation id is its linked one; a labelled
range's device time from the ops it holds on its thread).  A small
hand-made trace, in milliseconds."""

import pytest

import chip_smoke as CS

MS = 1_000_000  # ns


def _row(name, on_device, thread, start, end, corr=0, linked=0):
    return (name, on_device, thread, start * MS, end * MS, corr, linked)


ROWS = [
    # thread 1: a labelled range holding two ops and a nested labelled range
    _row("L", False, 1, 0, 100, corr=1),
    _row("aten::add", False, 1, 10, 20, corr=10),
    _row("cudaLaunchKernel", False, 1, 11, 12, corr=900, linked=10),
    _row("aten::mul", False, 1, 30, 40, corr=11),
    _row("L", False, 1, 50, 60, corr=12),  # a kernel launched by the range itself
    _row("aten::_local_scalar_dense", False, 1, 70, 71, corr=13),
    # thread 2: an op outside any range
    _row("aten::add", False, 2, 15, 25, corr=20),
    _row("profiler::_record_function_exit", False, 2, 26, 27, corr=21),
    # the device
    _row("k_add", True, 0, 100, 105, corr=900, linked=10),
    _row("k_mul", True, 0, 103, 110, corr=901, linked=11),
    _row("ntt_fwd_kernel", True, 0, 200, 202, corr=902, linked=12),
    _row("L", True, 0, 100, 202),  # the range on the device's timeline
    _row("k_add", True, 0, 300, 303, corr=903, linked=20),
    _row("Memcpy DtoH (Device -> Pageable)", True, 0, 400, 401, corr=904, linked=20),
]


def test_trace_summary_links_kernels_to_ops_and_ranges():
    out = CS.trace_summary(ROWS, labels=["L"])
    assert out["kernels"] == 5  # the range's device row is not a kernel
    assert out["top_ms"][0] == ["k_add", pytest.approx(8.0)]
    assert out["device_sum_ms"] == pytest.approx(5 + 7 + 2 + 3 + 1)
    assert out["device_busy_ms"] == pytest.approx(10 + 2 + 3 + 1)  # overlaps merged
    assert out["window_ms"] == pytest.approx(401)
    assert out["idle_share"] == pytest.approx(1 - 16 / 401)
    assert out["k1_ms"] == pytest.approx(2)
    # the outer range holds add, mul and the nested range (14 ms); the nested one 2
    assert out["labelled_ms"] == {"L": {"calls": 2, "device_ms": pytest.approx(16)}}
    # a copy an op issues is its device time too, as in torch.profiler's tables
    assert dict(out["aten_self_device_ms"]) == pytest.approx(
        {"aten::add": 9.0, "aten::mul": 7.0, "aten::_local_scalar_dense": 0.0})
    assert out["host_readbacks"] == 1
    assert out["dtoh_copies"] == 1
    assert out["host_threads"] == 2
    assert "profiler::_record_function_exit" not in out["table"]
    assert out["table"].splitlines()[1].split() == ["2", "20.000", "9.000", "aten::add"]


def test_trace_summary_of_a_host_only_trace():
    out = CS.trace_summary([r for r in ROWS if not r[1]])
    assert out["kernels"] == 0 and out["device_busy_ms"] == 0 and out["idle_share"] == 1.0
    assert out["labelled_ms"] == {} and out["host_threads"] == 2
