"""Reading a device trace: busy and idle time, kernel families, graph
launches and the breakdown, on a synthetic Chrome trace."""

from __future__ import annotations

import json
import types

import pytest

from perfbench.harness import spec, trace
from perfbench.tests.conftest import ROOT


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 0, "tid": 0}


@pytest.fixture()
def tr(tmp_path):
    events = [
        _ev(trace.WINDOW, "user_annotation", 1000.0, 1000.0),  # the window: 1000-2000 us
        _ev("void mocr::sm90::gemm_kernel<Int8>(CUtensorMap)", "kernel", 1100.0, 200.0),
        _ev("(anonymous namespace)::attention_kernel<64>", "kernel", 1250.0, 150.0),
        _ev("(anonymous namespace)::decode_cluster_kernel(ClusterParams)", "kernel", 1600.0,
            100.0),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1900.0, 50.0),
        _ev("ampere_sgemm_128x64_nn", "kernel", 900.0, 150.0),  # half outside the window
        _ev("cudaGraphLaunch", "cuda_runtime", 1090.0, 5.0),
        _ev("cudaGraphLaunch", "cuda_runtime", 1590.0, 5.0),
        _ev("cudaGraphLaunch", "cuda_runtime", 500.0, 5.0),  # before the window
        _ev("aten::copy_", "cpu_op", 1420.0, 150.0),  # the host during the 1400-1600 gap
        _ev("cudaEventSynchronize", "cuda_runtime", 1700.0, 190.0),
        _ev("not a complete event", "kernel", 1000.0, 10.0) | {"ph": "i"},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.read(str(path))


def test_busy_and_idle(tr):
    assert tr.window_s == pytest.approx(1e-3)
    # 1000-1050 (sgemm), 1100-1400, 1600-1700, 1900-1950: 500 us busy
    assert tr.busy_s() == pytest.approx(500e-6)
    run = types.SimpleNamespace(trace=tr)
    assert spec.reader(ROOT, "device_idle_pct")(run) == pytest.approx(50.0)
    assert spec.reader(ROOT, "device_idle_pct.serve")(run) == pytest.approx(50.0)


def test_families_and_counts(tr):
    kernels = spec.data(ROOT, "kernels")
    assert tr.device_time_s(kernels["encoder"]) == pytest.approx(350e-6)
    assert tr.device_time_s(kernels["decode"]) == pytest.approx(100e-6)
    assert tr.count_host("cudaGraphLaunch") == 2
    top = tr.top_device_ops(2)
    assert top[0][0].startswith("void mocr::sm90::gemm_kernel") and top[0][1] == pytest.approx(
        200e-6)


def test_idle_gaps_by_host_activity(tr):
    gaps = dict(tr.idle_gaps())
    # 1400-1600: aten::copy_ overlaps it most; 1700-1900: the sync; 1050-1100:
    # a graph launch; 1950-2000: nothing traced on the host
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["cudaEventSynchronize"] == pytest.approx(200e-6)
    assert gaps["cudaGraphLaunch"] == pytest.approx(50e-6)
    assert gaps["no traced host event"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(500e-6)


def test_no_window_annotation_is_an_error(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_ev("k", "kernel", 0.0, 1.0)]}))
    with pytest.raises(RuntimeError):
        trace.read(str(path))
