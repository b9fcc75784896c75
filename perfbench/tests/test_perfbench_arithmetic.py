"""The yardstick's arithmetic against hand counts, the trace reducers on
synthetic events, and window rates as work over time."""

from __future__ import annotations

import json
import types

import pytest

from perfbench import flops, readers, run, trace
from perfbench.trace import Event

TINY = {"encoder": {"d_model": 4, "ffn_dim": 8, "num_mel_bins": 2, "num_layers": 1},
        "decoder": {"hidden_size": 4, "head_dim": 2, "num_heads": 2, "num_kv_heads": 1,
                    "intermediate_size": 6, "num_layers": 1, "vocab_size": 10},
        "projector_pool_stride": 4}


def test_kernel_counts_equal_hand_counts():
    # #1: 2 rows of 3 frames, 1 head of 2; keys 3 and 2
    assert flops.encoder_attention(2, 3, 1, 2, [3, 2]) == (4 * 2 * 3 * 3 + 4 * 2 * 3 * 2,
                                                           4 * 2 * 3 * 2 * 2 + 2 * 3 * 4)
    # #2: one row of 3 positions, 2 query heads, 1 KV head, D 2: 1 + 2 + 3 keys
    f, b = flops.prefill_attention(1, 3, 2, 1, 2)
    assert f == 4 * 2 * 2 * 6 and b == (2 * 3 * 2 * 2 + 2 * 3 * 1 * 2) * 2
    # padded to 3, valid 2: the pad row is neither computed nor read nor written
    f2, b2 = flops.prefill_attention(1, 3, 2, 1, 2, lens=[2])
    assert f2 == 4 * 2 * 2 * 3 and b2 == (2 * 2 * 2 * 2 + 2 * 2 * 1 * 2) * 2
    assert (f2, b2) == flops.prefill_attention(1, 2, 2, 1, 2)
    fb, bb = flops.prefill_attention_backward(1, 3, 2, 1, 2, [3])
    assert fb == 2.5 * f
    assert bb == (2 * 3 * 2 * 2 + 2 * 3 * 2) * 2 + 3 * 2 * 3 * 4 + (3 * 2 * 2 + 2 * 3 * 2) * 2
    fb2, bb2 = flops.prefill_attention_backward(2, 3, 2, 1, 2, [3, 1])
    assert fb2 == 2.5 * 4 * 2 * 2 * (6 + 1)
    assert bb2 == (2 * 4 * 2 * 2 + 2 * 4 * 2) * 2 + 3 * 2 * 4 * 4 + (4 * 2 * 2 + 2 * 4 * 2) * 2
    # #4: one row, 5 cached rows: int8 K and V with fp32 scales
    f4, b4 = flops.decode_attention_update(1, 5, 2, 1, 2)
    assert f4 == 4 * 2 * 2 * 6
    assert b4 == 2 * 5 * 1 * (2 + 4) + 2 * 2 * 2 * 2 + 2 * 1 * 2 * 2 + 2 * 1 * (2 + 4)
    assert flops.least_s(989e12, 0) == pytest.approx(1.0)
    assert flops.least_s(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_equal_hand_counts():
    # encoder: 8 mel frames -> 4 encoder frames
    convs = 2 * 8 * 3 * 2 * 4 + 2 * 4 * 3 * 4 * 4
    layer = 2 * 4 * 4 * 16 + 2 * 4 * 2 * 4 * 8 + 4 * 16 * 4
    assert flops.encoder_flops(TINY, 8) == convs + layer
    assert flops.projector_flops(TINY, 3) == 2 * 3 * (16 * 4 + 16)
    per_layer = 4 * 2 * (2 * 2 + 2 * 1) + 3 * 4 * 6  # q k v o, then the MLP
    assert flops.decoder_layer_params(TINY) == per_layer
    assert flops.attention_flops(TINY, 3, 1) == 4 * 2 * 2 * (1 + 2 + 3)
    # one request: 8 frames (1 audio token), a prompt of 5, 3 new tokens
    want = (flops.encoder_flops(TINY, 8) + flops.projector_flops(TINY, 1)
            + 2 * per_layer * 5 + 4 * 2 * 2 * 15 + 2 * 4 * 10
            + 2 * per_layer * 2 + 4 * 2 * 2 * (6 + 7) + 2 * 2 * 4 * 10)
    assert flops.serve_row_flops(TINY, 8, 5, 3) == want
    lin, attn, head = 2 * per_layer * 5, 4 * 2 * 2 * 15, 2 * 5 * 4 * 10
    assert flops.train_row_flops(TINY, 8, 5) == (
        flops.encoder_flops(TINY, 8) + 2 * flops.projector_flops(TINY, 1)
        + 2 * lin + 3 * attn + 2 * head)


def lap_events(t0: float) -> list:
    """A marker at t0, an encoder event, two prefill (#2) events and two
    decode (#4) steps, with idle gaps between some of them."""
    n = trace.NAMES
    pre = "void attention_fwd_sm90<128, 64, true, false>(Params)"
    dec = "void decode_kernel<int8, 128, true>(Params)"
    assert n["prefill_attn"].search(pre) and n["decode_attn"].search(dec)
    return [Event("void erfinv_kernel", t0, t0 + 1),
            Event("void attention_fwd_sm90<64, 64, false, false>(Params)", t0 + 1, t0 + 3),
            Event(pre, t0 + 4, t0 + 5), Event(pre, t0 + 5, t0 + 6),
            Event(dec, t0 + 8, t0 + 9), Event(dec, t0 + 10, t0 + 11)]


def test_phases_idle_and_rooflines_on_synthetic_events():
    events = lap_events(0.0) + lap_events(20.0)
    units = trace.split_units(list(reversed(events)))
    assert [len(u.events) for u in units] == [6, 6]
    assert readers.encode_s(units[0]) == 4 and readers.prefill_s(units[0]) == 4
    # an untraced lap of 12 s: 8 of them before the first #4 event, 4 over 2 steps
    assert readers.decode_step_s(units[0], 2, 12.0) == 2.0
    assert readers.decode_step_s(units[0], 2, 0.0) is None
    assert trace.union_s(events) == 2 * 7 and trace.window_s(units) == 31
    gaps = trace.idle_gaps(units, lambda u: [(u.start, "encode"), (u.of("prefill_attn")[0].start,
                                                                    "prefill")])
    assert sum(gaps.values()) == 2 * 4
    ctx = readers.Context(kind="serve", units=units,
                          expected=[{"prefill_attn": [0.5, 0.5]}] * 2, model_flops=[989e12] * 2,
                          window_s=31.0, busy_s=16.0, peak_bytes=2**31, decode_steps=2,
                          unit_s=12.0)
    assert readers.roofline_pct(ctx, ("prefill_attn",), "prefill_attn") == pytest.approx(50.0)
    # a unit's 989e12 FLOPs in an untraced unit's 12 s; 8 busy seconds a unit of 12
    assert readers.mfu_pct(ctx) == pytest.approx(100 / 12)
    assert readers.idle_pct(ctx) == pytest.approx(100 * (1 - 8 / 12))
    assert readers.peak_gib(ctx) == 2.0
    # a kernel off the path, or launched otherwise, leaves its roofline silent
    ctx.expected = [{"prefill_attn": [0.5]}] * 2
    assert readers.roofline_pct(ctx, ("prefill_attn",), "prefill_attn") is None
    assert readers.mean_ms([None, 1.0]) is None


class SleepLap:
    """A fake lap whose units take 1, 1 and 7 ticks of a fake clock."""

    KIND = "serve"
    END_TO_END = {"rtfx": "audio_s/s", "setup_s": "s"}

    def __init__(self, clock):
        self.clock, self.n = clock, 0

    def setup(self):
        pass

    def unit(self):
        self.clock.t += (1, 1, 7)[self.n]
        self.n += 1

    def metrics(self, units, window_s):
        return {"rtfx": units * 10.0 / window_s}

    def counts(self, units):
        return units, 0

    def release(self):
        pass

    def check(self):
        return {"gap": {"value": 0.0, "limit": 1.0}}


def test_window_rate_is_all_work_over_all_time(monkeypatch, copy, capsys):
    clock = types.SimpleNamespace(t=0.0)
    lap = SleepLap(clock)
    module = types.SimpleNamespace(KIND="serve", END_TO_END=SleepLap.END_TO_END,
                                   Lap=lambda *a: lap)
    monkeypatch.setattr(run.cell, "load_lap", lambda name: module)
    monkeypatch.setattr(run.time, "perf_counter", lambda: clock.t)
    assert run.main(["--workload", "tiny.serve", "--seed", "3", "--seconds", "9",
                     "--device", "cpu"]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # 3 units in 9 ticks: 30 / 9, not the median unit's 10 / 1
    assert result["cpu_readings"]["rtfx"]["value"] == pytest.approx(3 * 10.0 / 9)
    assert result["metrics"] == {} and result["correct"] is True
    assert list(result)[-1] == "checks"


class SlowWhileTraced:
    """A fake lap and recorder: a unit takes 3 ticks under the profiler, 1
    without it."""

    def __init__(self, clock):
        self.clock, self.on, self.calls = clock, False, []

    def start(self):
        self.on = True
        self.calls.append("start")

    def marker(self):
        self.calls.append("marker")

    def stop(self):
        self.on = False
        self.calls.append("stop")

    def unit(self):
        self.clock.t += 3 if self.on else 1


@pytest.mark.parametrize("seconds,units", [(1, 2), (20, 20)])
def test_a_traced_window_times_its_units_before_the_profiler(monkeypatch, seconds, units):
    """The window runs as untraced (at least as many units as are traced),
    then the traced units: ``unit_s`` is the untraced pace, not the
    profiler's."""
    clock = types.SimpleNamespace(t=0.0)
    fake = SlowWhileTraced(clock)
    monkeypatch.setattr(run.time, "perf_counter", lambda: clock.t)
    win = run.window(fake, seconds, recorder=fake, traced=2)
    assert win["units"] == units + 2 and win["window_s"] == units
    assert win["unit_s"] == 1.0 and win["traced_s"] == 3.0
    assert win["ends"][-3:] == [units, units + 3, units + 6]
    assert fake.calls == ["start", "marker", "marker", "stop"]
    # untraced: the window alone
    plain = run.window(SlowWhileTraced(clock), 5)
    assert plain["units"] == 5 and plain["unit_s"] == 1.0 and plain["traced_s"] == 0.0
