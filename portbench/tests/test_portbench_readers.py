"""The traced run's readers: the Lorenzo byte count against the kernel
table, the profiler reduction, the stage wrappers and the metric modules."""

from types import SimpleNamespace

import pytest

from portbench import spec, tracing


def _reader(name):
    return spec.metric_reader(name)


def test_lorenzo_least_time_matches_the_kernel_table():
    mod = _reader("lorenzo_roofline").__globals__
    assert mod["least_seconds"]((1800, 3600)) * 1e3 == pytest.approx(0.015475, abs=5e-7)
    assert mod["least_seconds"]((100, 500, 500)) * 1e3 == pytest.approx(0.059701, abs=5e-7)


def _ev(name, s, e, cuda=False):
    return SimpleNamespace(name=name, time_range=SimpleNamespace(start=s, end=e),
                           device_type="DeviceType.CUDA" if cuda else "DeviceType.CPU")


def test_reduce_unions_device_time_and_labels_gaps():
    events = [
        _ev("portbench_stretch", 0, 1000),
        _ev("portbench_stretch", 40, 990, True),  # the annotation's device-side span
        _ev("k_a", 50, 150, True), _ev("k_a", 120, 200, True),  # overlap counts once
        _ev("lorenzo2d_kernel(float const*, int*)", 500, 520, True),
        _ev("k_b", 950, 1200, True),  # cut at the stretch's end
    ]
    # host spans in seconds on the host clock; the stretch began at 5.0
    host = [("request", 5.0, 5.001), ("select_many", 5.0001, 5.0004), ("encode", 5.0004, 5.0009)]
    tr = tracing.reduce(events, host, 5.0)
    assert tr.window_s == pytest.approx(1000e-6)
    assert tr.busy_s == pytest.approx((150 + 20 + 50) * 1e-6)
    labels = dict((k, v) for k, v in tr.gaps if v > 0)
    assert set(labels) == {"request", "select_many", "encode"}
    assert tr.top_gaps(1)[0][0] == "encode"
    assert tr.top_ops()[0][0] == "k_b"
    ctx = {"trace": tr, "stretch_sz_device_fields": 2, "field_shape": (1800, 3600)}
    share = _reader("lorenzo_roofline")(ctx)
    assert share == pytest.approx(100 * 2 * 15.4746e-6 / 20e-6, rel=1e-4)
    assert _reader("device_idle_share")(ctx) == pytest.approx(100 * (1 - 220 / 1000))


def test_reduce_refuses_a_trace_without_device_work():
    with pytest.raises(RuntimeError, match="no device operation"):
        tracing.reduce([_ev("portbench_stretch", 0, 10), _ev("request", 0, 10, True)], [], 0.0)


def test_readers_return_nothing_when_there_is_nothing_to_read():
    empty = {"requests": [{"wall_s": 1.0, "select_s": 0.0, "solve_s": 0.0, "decided_s": None}],
             "declines": 0, "lossy_fields": 0, "trace": None,
             "stretch_sz_device_fields": 0, "field_shape": (8, 8)}
    for name in ("select_share", "solve_share", "encode_share", "declined_share",
                 "lorenzo_roofline", "device_idle_share", "select_share.3d",
                 "encode_share.3d", "declined_share.3d", "lorenzo3d_roofline",
                 "device_idle_share.3d", "compress_GBps.3d"):
        assert _reader(name)(empty) is None


def test_stage_shares():
    ctx = {"requests": [{"wall_s": 2.0, "select_s": 0.5, "solve_s": 0.0, "decided_s": 0.6},
                        {"wall_s": 2.0, "select_s": 0.3, "solve_s": 0.0, "decided_s": 0.4}],
           "declines": 1, "lossy_fields": 8}
    assert _reader("select_share")(ctx) == pytest.approx(20.0)
    assert _reader("encode_share")(ctx) == pytest.approx(75.0)
    assert _reader("solve_share")(ctx) is None
    assert _reader("declined_share")(ctx) == pytest.approx(12.5)


def test_per_layer_readings_of_the_3d_cells_match_their_originals():
    ctx = {"requests": [{"wall_s": 2.0, "select_s": 0.5, "solve_s": 0.0, "decided_s": 0.6}],
           "declines": 1, "lossy_fields": 8, "raw_bytes": 2_600_000_000, "window_s": 20.0}
    for name in ("select_share", "encode_share", "declined_share"):
        assert _reader(name + ".3d")(ctx) == _reader(name)(ctx)
    assert _reader("compress_GBps.3d")(ctx) == pytest.approx(0.13)


def test_wrappers_time_the_calls_and_fail_by_name(monkeypatch):
    from repro_torch.core import api

    spans = tracing.Spans()
    spans.install()
    try:
        assert api.select_many.__wrapped__ is not None
    finally:
        spans.uninstall()
    assert not hasattr(api.select_many, "__wrapped__")
    monkeypatch.delattr(api, "encode_with_selection")
    with pytest.raises(AttributeError, match="repro_torch.core.api.encode_with_selection"):
        tracing.Spans().install()


def test_stage_times_from_spans():
    _stage_times = spec.module("loads", "closed_loop")._stage_times

    spans = tracing.Spans(records=[("select_many", 1.0, 1.5), ("encode", 1.6, 2.9),
                                   ("solve_many", 5.0, 5.2)])
    st = _stage_times([(1.0, 3.0), (4.9, 6.0)], spans)
    assert st[0] == {"wall_s": 2.0, "select_s": 0.5, "solve_s": 0.0, "decided_s": 0.5}
    assert st[1]["solve_s"] == pytest.approx(0.2) and st[1]["decided_s"] == pytest.approx(0.3)
