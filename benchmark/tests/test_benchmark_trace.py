"""The device idle share from the union of device intervals."""

import json

import pytest

from benchmark.lib import trace


def synthetic(device, start=0.0, end=100.0, host=()):
    return trace.Trace(device=[trace.Op(f"k{i}", s, e, "kernel")
                               for i, (s, e) in enumerate(device)],
                       host=[trace.Op(n, s, e, "cpu_op") for n, s, e in host],
                       start=start, end=end)


def test_overlapping_launches_are_counted_once():
    # programmatic dependent launches: each kernel starts before the one
    # ahead of it ends; their durations sum to 120 of a 100 us stretch
    t = synthetic([(0, 40), (30, 70), (60, 100)])
    assert t.busy_s == pytest.approx(100e-6)
    assert t.idle_share() == pytest.approx(0.0)


@pytest.mark.parametrize("intervals", [
    [(0, 100)] * 5,
    [(-50, 30), (10, 20), (15, 25), (90, 400)],
    [(i, i + 7) for i in range(0, 100, 3)],
])
def test_idle_share_never_below_zero(intervals):
    assert 0.0 <= synthetic(intervals).idle_share() <= 1.0


def test_gaps_are_the_stretch_less_the_union_named_by_the_host():
    t = synthetic([(10, 20), (15, 30), (60, 80)],
                  host=[("aten::outer", 0, 100), ("aten::inner", 35, 55)])
    assert t.busy_s == pytest.approx(40e-6)
    gaps = t.idle_gaps()
    assert [g for _, g in gaps] == pytest.approx([30e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "host: aten::inner"      # 30..60, middle 45
    assert sum(g for _, g in gaps) == pytest.approx(t.window_s - t.busy_s)


def test_device_ops_sum_by_name_and_kernels_leave_out_copies():
    t = trace.Trace(device=[trace.Op("a", 0, 5, "kernel"),
                            trace.Op("a", 10, 15, "kernel"),
                            trace.Op("Memcpy", 20, 40, "gpu_memcpy")],
                    host=[], start=0, end=50)
    assert t.device_ops()[0] == ("Memcpy", pytest.approx(20e-6))
    assert dict(t.device_ops())["a"] == pytest.approx(10e-6)
    assert len(t.kernels()) == 2


def test_read_takes_the_stretch_from_a_chrome_trace(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
         "ts": 100, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "conv3x3_kernel<128, 128, 4>",
         "ts": 110, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "se_residual_kernel",
         "ts": 125, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 100,
         "dur": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = trace.read(str(path))
    assert t.window_s == pytest.approx(50e-6)
    assert t.busy_s == pytest.approx(25e-6)
    assert len(t.kernels("conv3x3_kernel")) == 1


def test_a_trace_with_no_device_operation_is_refused(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": trace.STRETCH,
         "ts": 0, "dur": 5}]}))
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.read(str(path))


def test_launch_classes_sort_hand_library_and_rest():
    t = trace.Trace(device=[
        trace.Op("void (anonymous namespace)::conv3x3_kernel<128, 16, 1>",
                 0, 4, "kernel"),
        trace.Op("sm90_xmma_fprop_implicit_gemm_cudnn", 4, 6, "kernel"),
        trace.Op("nvjet_tst_64x8", 6, 7, "kernel"),
        trace.Op("void at::native::vectorized_elementwise_kernel", 7, 8,
                 "kernel"),
        trace.Op("Memcpy DtoD", 8, 9, "gpu_memcpy")], host=[], start=0,
        end=10)
    c = t.launch_classes()
    assert [c[k]["launches"] for k in ("hand", "library", "rest")] == [1, 2, 1]
    assert c["hand"]["seconds"] == pytest.approx(4e-6)
