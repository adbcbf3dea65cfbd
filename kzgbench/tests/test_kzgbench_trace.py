"""The trace reader on a hand-made Chrome trace."""

import json

from kzgbench import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _trace(tmp_path):
    ev = [
        _x("user_annotation", "warmup.batch", 0, 50),
        _x("kernel", "void k_fr_ewise<8>(int)", 10, 5, tid=7, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
        _x("user_annotation", "window.batch", 100, 100),
        _x("user_annotation", "intt", 100, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 105, 1, correlation=2),
        _x("kernel", "void k_ntt_pass<8>(unsigned int const*)", 110, 10,
           tid=7, correlation=2),
        _x("user_annotation", "commit.polys", 120, 60),
        _x("cuda_driver", "cuLaunchKernel", 125, 1, correlation=3),
        _x("kernel", "void k_msm_accumulate<true, 12>(int)", 130, 30,
           tid=7, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 126, 1, correlation=4),
        _x("kernel", "void k_msm_horner<12>(int)", 165, 5, tid=7,
           correlation=4),
        _x("gpu_memcpy", "Memcpy DtoH", 172, 2, tid=7, correlation=99),
        _x("user_annotation", "host.challenge", 180, 20),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_summary_attributes_kernels_to_spans(tmp_path):
    s = trace.summarize(_trace(tmp_path))
    assert s["batches"] == 1
    assert s["window_us"] == 100
    assert s["busy_us"] == 10 + 30 + 5 + 2
    assert s["span_device_us"] == {"window.batch": 45, "intt": 10,
                                   "commit.polys": 35}
    assert s["unattributed"] == 1                  # the copy: no launch
    assert s["kernel_us"]["k_msm_accumulate<true, 12>"] == 30
    assert "k_fr_ewise<8>" not in s["kernel_us"]    # before the window
    idle = s["idle_by_span_us"]
    assert idle["intt"] == 10 + 0                  # 100-110 idle in intt
    assert idle["host.challenge"] == 26            # 174-200
    assert abs(sum(idle.values()) + s["busy_us"] - s["window_us"]) < 1e-9


def test_breakdown_is_short_and_in_seconds(tmp_path):
    b = trace.breakdown(trace.summarize(_trace(tmp_path)))
    assert b["device_ops"][0] == ["k_msm_accumulate<true, 12>", 30e-6]
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_short_name_keeps_templates():
    assert trace.short_name("void k_scan<0, 8>(unsigned int const*, long)") \
        == "k_scan<0, 8>"
    assert trace.short_name("void (anonymous namespace)::k_msm_horner<12>"
                            "(unsigned int const*, int)") == "k_msm_horner<12>"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH "


def test_device_idle_takes_the_wall_time_of_untraced_batches(tmp_path):
    from types import SimpleNamespace

    from kzgbench.metrics import device_idle
    s = trace.summarize(_trace(tmp_path))            # 47 us busy, 1 batch
    record = SimpleNamespace(trace=s, traced_batches=1,
                             batches=[(0.0, 1e-3, 2), (1e-3, 1.1e-3, 2),
                                      (1.1e-3, 1.2e-3, 2)])
    assert abs(device_idle.read(record) - 100.0 * (1 - 47 / 100)) < 1e-9
    record.batches = record.batches[:1]              # none after the trace
    assert device_idle.read(record) is None
