"""The readers of the program's spans (``perfbench/spans.py``): on
synthetic spans and events (the dispatch and wait split, idle put down to
the innermost span, launch calls inside decode steps, nothing read without
spans), and on the tiny program's own spans on the CPU."""

from __future__ import annotations

import pytest
import torch

from perfbench import cell, spans, trace
from perfbench.trace import Event


def rec(i, name, start, end, parent=None, device_ms=None, root=None):
    """A span record with times in seconds."""
    return {"name": name, "id": i, "parent": parent, "root": root or i,
            "start_ns": int(start * 1e9), "end_ns": int(end * 1e9), "device_ms": device_ms,
            "attrs": {}}


def lap_spans(t0: float = 0.0) -> list:
    """A lap: generate [0, 10] holding prefill [0.5, 2] and two decode steps,
    the first ending in its read; then the fetch and post-processing."""
    return [rec(2, "prefill", t0 + 0.5, t0 + 2, 1, device_ms=700.0),
            rec(3, "sync.finished", t0 + 4, t0 + 5, 4),
            rec(4, "decode_step", t0 + 2, t0 + 5, 1, device_ms=2.0),
            rec(5, "decode_step", t0 + 5, t0 + 8, 1, device_ms=2.0),
            rec(6, "sync.fetch", t0 + 8, t0 + 8.5, 1),
            rec(1, "generate", t0, t0 + 8.5, None, device_ms=800.0),
            rec(7, "postprocess", t0 + 8.5, t0 + 9.5),
            rec(8, "mel", t0 - 1, t0 - 0.5, device_ms=5.0),
            rec(9, "encode", t0 + 0.1, t0 + 0.4, 1, device_ms=100.0)]


def test_the_dispatch_and_wait_split_of_decode_steps():
    unit = lap_spans()
    # steps of 3 s each; the first waits 1 s in its read, the last has none
    assert spans.decode_split_ms(unit) == pytest.approx((2500.0, 500.0))
    assert spans.host_syncs(unit) == 2 and spans.host_syncs([]) is None
    assert spans.postprocess_ms(unit) == pytest.approx(1500.0)
    assert spans.device_ms(unit, "mel", "encode") == 105.0
    assert spans.device_ms(unit, "prefill") == 700.0
    # a span without device time (off the card) leaves the sum unread
    assert spans.device_ms(unit, "sync.fetch") is None and spans.device_ms(unit, "nope") is None
    assert spans.decode_split_ms([r for r in unit if r["name"] != "decode_step"]) is None
    assert spans.median([3.0, 1.0, 2.0]) == 2.0 and spans.median([1.0, 2.0]) == 1.5
    assert spans.median([1.0, None]) is None and spans.median([]) is None


def test_idle_is_put_down_to_the_innermost_span():
    records = lap_spans()
    gaps = [(1.0, 3.0), (4.5, 6.0), (9.0, 11.0)]
    by = spans.idle_by_span(gaps, records)
    assert by == pytest.approx({"prefill": 1.0, "decode_step": 2.0, "sync.finished": 0.5,
                                "postprocess": 0.5, spans.OUTSIDE: 1.5})
    segments = spans.innermost(records)
    assert all(a < b for a, b, _ in segments)
    assert all(s[1] <= t[0] for s, t in zip(segments, segments[1:]))
    assert (2.0, 4.0, "decode_step") in [(round(a, 6), round(b, 6), n) for a, b, n in segments]


def test_launch_calls_inside_decode_steps():
    unit = lap_spans()
    launches = [Event("cudaLaunchKernel", t, t + 0.01) for t in (1.0, 2.5, 3.0, 4.5, 5.5, 9.0)]
    # 2.5, 3.0, 4.5 in the first step; 5.5 in the second
    assert spans.launches_per_step(unit, launches) == 2.0
    assert spans.launches_per_step(unit, []) is None
    assert spans.launches_per_step([r for r in unit if r["name"] != "decode_step"],
                                   launches) is None
    assert all(spans.LAUNCH.search(n) for n in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
        "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemcpy2DAsync", "cudaMemsetAsync"))
    assert not any(spans.LAUNCH.search(n) for n in (
        "cudaEventRecord", "cudaStreamSynchronize", "cudaMemcpy", "cudaGetDevice"))


def test_idle_intervals_run_from_marker_to_marker():
    marker = "void erfinv_kernel"
    events = [Event(marker, 0, 1), Event("k", 2, 3), Event("k", 2.5, 4),
              Event(marker, 6, 7), Event("k", 7, 8)]
    units = trace.split_units(events)
    # unit 0: idle 1-2 and 4-6 (to the next marker); unit 1: 8-9 (to the end)
    assert spans.idle_intervals(units, end=9.0) == [[(1, 2), (4, 6)], [(8, 9.0)]]
    assert spans.idle_intervals(units) == [[(1, 2), (4, 6)], []]


def test_sync_offsets_and_units_by_marks():
    compute = [Event("a", 0.0, 1.0), Event("b", 1.0, 2.0), Event("c", 3.0, 4.0)]
    records = [rec(1, "sync.finished", 1.5, 2.0001), rec(2, "sync.fetch", 2.5, 2.9),
               rec(3, "decode_step", 0, 5)]
    offsets = spans.sync_offsets_ms(records, compute)
    assert offsets == pytest.approx([0.1, 900.0], abs=1e-3)
    assert spans.sync_offsets_ms(records, compute, "sync.finished") == pytest.approx(
        [0.1], abs=1e-3)
    by = spans.split_by_marks([rec(1, "a", 0.5, 1), rec(2, "b", 1.5, 2), rec(3, "c", 3, 4)],
                              [1.0, 2.0])
    assert [[r["name"] for r in u] for u in by] == [["b"], ["c"]]


def train_step_spans() -> list:
    """An optimizer step of two micro-steps, each holding forward (with
    ce_loss inside) and backward, then the update and its two reads."""
    return [rec(1, "micro_step", 0, 5), rec(2, "forward", 0, 2, 1, device_ms=10.0),
            rec(3, "ce_loss", 1, 2, 2, device_ms=3.0), rec(4, "backward", 2, 4, 1, device_ms=20.0),
            rec(5, "micro_step", 5, 9), rec(6, "forward", 5, 6, 5, device_ms=11.0),
            rec(7, "ce_loss", 5, 6, 6, device_ms=4.0), rec(8, "backward", 6, 8, 5, device_ms=21.0),
            rec(9, "update", 9, 10, device_ms=5.0), rec(10, "sync.finite", 9, 9.1, 9),
            rec(11, "sync.clip", 9.2, 9.3, 9)]


def test_the_training_reductions_and_nothing_without_spans():
    step = train_step_spans()
    got = {name: spans.device_ms(step, name) for name in ("forward", "ce_loss", "backward",
                                                          "update")}
    assert got == {"forward": 21.0, "ce_loss": 7.0, "backward": 41.0, "update": 5.0}
    assert spans.host_syncs(step) == 2
    # a step has no decode loop, and a lap no training phase
    assert spans.decode_split_ms(step) is None and spans.postprocess_ms(step) is None
    assert spans.launches_per_step(step, [Event("cudaLaunchKernel", 1.0, 1.0)]) is None
    assert spans.device_ms(lap_spans(), "forward", "backward") is None
    # a program without spans gives empty units: nothing to read, no idle put
    # down to a span
    assert spans.median([spans.host_syncs(u) for u in ([], [])]) is None
    assert spans.median([spans.device_ms(u, "mel", "encode") for u in ([], [])]) is None
    assert spans.idle_by_span([(0.0, 1.0)], []) == {spans.OUTSIDE: 1.0}


def test_the_decode_spans_against_the_subtracted_step():
    """Each spans-on lap's dispatch + wait + post-processing a step, against
    ``decode_step_ms.offline``'s subtraction on that lap's own host seconds
    and on the window's."""
    traced = trace.Unit([Event("void erfinv_kernel", 50.0, 50.001),
                         Event("void decode_kernel<int8, 128, true>(Params)", 51.0, 51.002)])
    got = spans.decode_agreement([lap_spans(), lap_spans(100.0)], [8.5, 9.0], [traced], 2, 11.0)
    # a step: 2500 dispatch + 500 wait + 1500 / 2 post-processing; the
    # subtraction: (lap seconds - 1 s to the first #4 event) / 2 steps
    assert got["spans"] == pytest.approx([3750.0, 3750.0])
    assert got["same_laps"] == pytest.approx([3750.0, 4000.0])
    assert got["window"] == pytest.approx(5000.0)
    assert got["over_same_laps"] == pytest.approx((1.0 + 3750.0 / 4000.0) / 2 - 1)
    assert got["over_window"] == pytest.approx(-0.25)
    # nothing to compare: no decode spans, no traced laps, no decode steps
    assert spans.decode_agreement([[rec(1, "generate", 0, 1)]], [1.0], [traced], 2, 11.0) is None
    assert spans.decode_agreement([lap_spans()], [8.5], [], 2, 11.0) is None
    assert spans.decode_agreement([lap_spans()], [8.5], [traced], 0, 11.0) is None
    assert spans.decode_agreement([train_step_spans()], [8.5], [traced], 2, 11.0) is None


def test_without_program_spans_nothing_runs(monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: None)

    class NoUnits:
        def unit(self):
            raise AssertionError("a unit ran")

    assert spans.spans_on_units(NoUnits(), 3) == {"units": [], "unit_s": []}
    # a plain run asks for no spans-on units: the program's spans stay off
    monkeypatch.setattr(spans, "program_spans", lambda: pytest.fail("spans turned on"))
    assert spans.spans_on_units(NoUnits(), 0) == {"units": [], "unit_s": []}


@pytest.mark.parametrize("workload,reads", [("tiny.serve", 16 + 2), ("tiny.train", 2 * 3 + 2)])
def test_the_readers_read_the_tiny_programs_spans(copy, workload, reads):
    """Spans-on units of the tiny cells on the CPU: every read a sync span
    (serving: the prompt's and EOS ids' copies, 15 per-step reads, the
    fetch; training: three batch copies a micro-step, two optimizer reads),
    the host reductions read, the device ones (no CUDA events) not."""
    spec = cell.load_workload(workload)
    lap = cell.load_lap(spec["lap"]).Lap(spec, cell.load_config(spec["config"]), 5,
                                         torch.device("cpu"))
    lap.setup()
    out = spans.spans_on_units(lap, 2)
    assert len(out["units"]) == len(out["unit_s"]) == 2
    units = out["units"]
    assert [spans.host_syncs(u) for u in units] == [reads, reads]
    if cell.load_lap(spec["lap"]).KIND == "serve":
        for dispatch, wait in map(spans.decode_split_ms, units):
            assert dispatch > 0 and wait >= 0
        assert all(spans.postprocess_ms(u) > 0 for u in units)
        device = ("mel", "encode", "prefill")
    else:
        device = ("forward", "ce_loss", "backward", "update")
    for name in device:
        assert all(spans.named(u, name) for u in units)
        assert spans.median([spans.device_ms(u, name) for u in units]) is None
    # spans are off again after the units
    from tiny_audio_tpu_torch.utils import profiling

    assert profiling.span("a") is profiling.span("b")
