"""``programspans.py`` on the CPU: the idle gaps of a profiled slice
labelled by the benchmark span and split by the innermost program spans
(summed by the benchmark's label, ``devicetrace.idle_gaps``), the
profiler's events split with the program's ranges kept off the device,
and a tiny traced Bookinfo run read through the program's tracer."""

from __future__ import annotations

import types

from xlbench import devicetrace, programspans
from xlbench.tests import tiny

# two ticks: traffic, then the loop's tick holding ingress and the tick
# call; the program's spans nested inside the loop's tick
HOST = [("tick", 0.0, 10.0), ("traffic", 0.0, 1.0), ("loop_tick", 1.0, 9.0),
        ("ingress", 1.5, 2.5), ("tick_call", 3.0, 5.0),
        ("download", 5.0, 5.5),
        ("xlb::serve_loop.tick", 1.1, 8.9),
        ("xlb::serve_loop.ingress", 1.4, 2.6),
        ("xlb::serve_loop.step", 2.9, 5.6),
        ("xlb::static_tick.stage", 3.1, 3.9),
        ("xlb::static_tick.replay", 3.9, 4.9),
        ("xlb::serve_loop.complete", 5.6, 7.0),
        ("xlb::serve_loop.requeue", 7.0, 8.9)]
# device operations; the gaps between them fall in each of the spans
DEVICE = [("k", 0.0, 0.2), ("k", 0.8, 1.2), ("k", 1.9, 2.1),
          ("k", 3.2, 3.4), ("k", 3.6, 4.0), ("k", 4.6, 4.8),
          ("k", 5.3, 5.4), ("k", 6.0, 6.1), ("k", 7.2, 7.3),
          ("k", 8.95, 9.3), ("k", 9.9, 10.0)]


def test_idle_gaps_nest_program_spans_under_the_benchmark_labels():
    got = programspans.idle_gaps(DEVICE, HOST)
    want = {"traffic": 0.6,                                   # 0.2-0.8
            "ingress/serve_loop.tick": 0.2,                   # 1.2-1.4
            "ingress/serve_loop.ingress": 0.5,                # 1.4-1.9
            # 2.1-3.2: the benchmark's label at its middle, the program's
            # split by overlap
            "bookkeeping/serve_loop.ingress": 0.5,            # 2.1-2.6
            "bookkeeping/serve_loop.tick": 0.3,               # 2.6-2.9
            "bookkeeping/serve_loop.step": 0.4,      # 2.9-3.1, 5.4-5.6
            "bookkeeping/static_tick.stage": 0.1,             # 3.1-3.2
            "tick_call/static_tick.stage": 0.2,               # 3.4-3.6
            "tick_call/static_tick.replay": 0.6,              # 4.0-4.6
            "download/static_tick.replay": 0.1,               # 4.8-4.9
            "download/serve_loop.step": 0.4,                  # 4.9-5.3
            "bookkeeping/serve_loop.complete": 1.3,   # 5.6-6.0, 6.1-7.0
            "bookkeeping/serve_loop.requeue": 1.8,    # 7.0-7.2, 7.3-8.9
            "bookkeeping": 0.05,                # 8.9-8.95: no program span
            "between ticks": 0.6}                             # 9.3-9.9
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) < 1e-9, k
    old = devicetrace.idle_gaps(DEVICE, HOST)
    summed = programspans.by_prefix(got)
    assert set(summed) == set(old)
    for k, v in old.items():
        assert abs(summed[k] - v) < 1e-9, k


def test_without_program_spans_the_labels_are_the_old_ones():
    bench_only = [h for h in HOST if not h[0].startswith("xlb::")]
    assert programspans.idle_gaps(DEVICE, bench_only) == \
        devicetrace.idle_gaps(DEVICE, bench_only)


def test_events_keep_ranges_and_their_shadows_off_the_device():
    from torch.autograd import DeviceType

    def ev(name, dev, a, b):
        return types.SimpleNamespace(
            name=name, device_type=dev,
            time_range=types.SimpleNamespace(start=a * 1e6, end=b * 1e6))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    prof = types.SimpleNamespace(events=lambda: [
        ev("xlbench::tick", cpu, 0, 9), ev("xlbench::tick", cuda, 1, 2),
        ev("xlb::serve_loop.step", cpu, 1, 3),
        ev("xlb::serve_loop.step", cuda, 1, 2),
        ev("admit_kernel", cuda, 1, 1.5), ev("aten::add", cpu, 1, 1.1)])
    dev, host = programspans.events(prof)
    assert dev == [("admit_kernel", 1.0, 1.5)]
    assert host == [("tick", 0.0, 9.0), ("xlb::serve_loop.step", 1.0, 3.0)]


def test_a_traced_cpu_run_reads_the_program_spans():
    name = "bookinfo.closed"
    cfg, spec = tiny.bookinfo()
    out, prog = programspans.execute(
        name, 5, 0.6, True, device="cpu",
        bench=tiny.bench_for(name, cfg, "tiny"), cfg=cfg, spec=spec, t0=0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["ingress_ms_per_tick.mesh"]["value"] > 0
    ticks = prog["window_ticks"]
    assert ticks > 0 and prog["span_calls"]["serve_loop.tick"] == ticks
    for k, v in prog["readings"].items():
        assert v is not None and v > 0, k
    # the program counts the window's holds as the benchmark does
    held = prog["counters"]["serve_loop.held"]
    assert held > 0
    assert held == prog["held_by_the_benchmark"]
    assert prog["counters"]["serve_loop.taken"] == \
        prog["attempts_by_the_benchmark"]
    assert prog["checks"]["held_equal"][2]
    assert prog["queue_wait_ms"]["n"] > 0
    assert prog["graphs"]["graphs"] == 0            # no graph on the CPU
    spans = prog["spans_ms_per_tick"]
    assert sum(v for k, v in spans.items() if k.startswith("static_tick.")) \
        <= spans["serve_loop.step"]
