"""The port's fault injection (repro_torch.faults, numpy only) against the
reference (repro.faults): the same plan gives bitwise the same packet
masks, element keep masks, frame events and retransmission info dicts,
over a grid of seeds, rates, schedules, payload shapes and recovery modes,
and raises ChannelErasure at the same step; the link's per-direction draws
(Channel / SplitLink.next_erasure) equal the reference link's."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro import faults as jfaults  # noqa: E402
from repro import transport as jtransport  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch import transport  # noqa: E402

SEEDS = [0, 7, 123]
RATES = [
    {"drop": 0.1},
    {"drop": 0.3, "corrupt": 0.05},
    {"fwd": {"drop": 0.2}, "bwd": {"corrupt": 0.4}},
    {"drop": 0.05, "fwd": {"drop": 0.5}},
    {"drop": 1.0},
]
SCHEDULES = [None, {2: "drop"}, {"bwd": {0: ("corrupt", "drop"), 3: "drop"}},
             {1: jfaults.FaultEvent("drop", 0.25)}]
SHAPES = [(16, 2048), (4, 2048), (3, 4, 64), (2, 10), (64,)]
POLICIES = [None, dict(mode="erasure"), dict(mode="erasure", max_erasure_frac=0.05),
            dict(mode="retransmit"), dict(mode="retransmit", retry_budget=0),
            dict(mode="erasure", max_erasure_frac=0.0, retry_budget=1)]


def _port_schedule(schedule):
    """The reference schedule with its FaultEvents rebuilt as the port's."""
    if schedule is None:
        return None

    def conv(ev):
        if isinstance(ev, jfaults.FaultEvent):
            return faults.FaultEvent(ev.kind, ev.arg)
        if isinstance(ev, tuple):
            return tuple(conv(e) for e in ev)
        return ev
    if all(isinstance(k, int) for k in schedule):
        return {k: conv(v) for k, v in schedule.items()}
    return {d: {k: conv(v) for k, v in s.items()} for d, s in schedule.items()}


def _plans(seed, rates, schedule, packets=16):
    return (jfaults.FaultPlan(seed=seed, rates=rates, schedule=schedule,
                              packets=packets),
            faults.FaultPlan(seed=seed, rates=rates,
                             schedule=_port_schedule(schedule), packets=packets))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rates", RATES, ids=range(len(RATES)))
@pytest.mark.parametrize("schedule", SCHEDULES, ids=range(len(SCHEDULES)))
def test_packet_masks_and_frame_events_equal_reference(seed, rates, schedule):
    j, t = _plans(seed, rates, schedule)
    assert t.is_zero() == j.is_zero()
    assert t.rates == j.rates
    for direction in ("fwd", "bwd", "c2s"):
        assert t.rates_for(direction) == j.rates_for(direction)
        for step in range(3):
            for shape in SHAPES[1:4]:
                for attempt in (0, 1):
                    np.testing.assert_array_equal(
                        t.packet_faults(direction, step, shape, attempt),
                        j.packet_faults(direction, step, shape, attempt))
                np.testing.assert_array_equal(
                    t.payload_keep(direction, step, shape),
                    j.payload_keep(direction, step, shape))
            for epoch in (0, 1):
                got = t.frame_events(direction, step, epoch)
                want = j.frame_events(direction, step, epoch)
                assert [(e.kind, e.arg) for e in got] == \
                    [(e.kind, e.arg) for e in want]


@pytest.mark.parametrize("policy", POLICIES, ids=range(len(POLICIES)))
@pytest.mark.parametrize("rates", RATES[:4], ids=range(4))
def test_negotiate_payload_equals_reference(policy, rates):
    """Keep masks and info dicts bitwise equal; a ChannelErasure raised at
    the same (direction, step) with the same fields."""
    for seed in SEEDS:
        j, t = _plans(seed, rates, {"fwd": {1: "drop"}})
        jp = None if policy is None else jfaults.RecoveryPolicy(**policy)
        tp = None if policy is None else faults.RecoveryPolicy(**policy)
        for direction in ("fwd", "bwd"):
            for step in range(4):
                for shape in SHAPES[:3]:
                    try:
                        want = jfaults.negotiate_payload(j, direction, step,
                                                         shape, jp)
                    except jfaults.ChannelErasure as e:
                        with pytest.raises(faults.ChannelErasure) as got:
                            faults.negotiate_payload(t, direction, step, shape, tp)
                        assert str(got.value) == str(e)
                        assert (got.value.direction, got.value.step,
                                got.value.erased_frac, got.value.attempts) == \
                            (e.direction, e.step, e.erased_frac, e.attempts)
                        continue
                    keep, info = faults.negotiate_payload(t, direction, step,
                                                          shape, tp)
                    assert keep.dtype == want[0].dtype == np.float32
                    np.testing.assert_array_equal(keep, want[0])
                    assert info == want[1]


def test_validation_errors_match_reference():
    for kw in (dict(packets=0), dict(rates={"nope": 0.1}),
               dict(rates={"drop": 1.5}), dict(schedule={0: "nope"})):
        with pytest.raises(ValueError) as want:
            jfaults.FaultPlan(**kw)
        with pytest.raises(ValueError) as got:
            faults.FaultPlan(**kw)
        assert str(got.value) == str(want.value)
    for kw in (dict(mode="x"), dict(max_erasure_frac=2.0), dict(retry_budget=-1)):
        with pytest.raises(ValueError) as want:
            jfaults.RecoveryPolicy(**kw)
        with pytest.raises(ValueError) as got:
            faults.RecoveryPolicy(**kw)
        assert str(got.value) == str(want.value)
    assert faults.FaultPlan().is_zero() and faults.FaultPlan(rates={"drop": 0}).is_zero()
    np.testing.assert_array_equal(faults.erasure_mask_like((2, 3)),
                                  jfaults.erasure_mask_like((2, 3)))
    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert repr(faults.FaultPlan(3, {"drop": 0.1}, {2: "drop"})) == \
        repr(jfaults.FaultPlan(3, {"drop": 0.1}, {2: "drop"}))


@pytest.mark.parametrize("spec", [
    "c3sl:R=4,D=64",
    "c3sl:R=4,D=64 >> bwd:c3sl:R=2,D=64|int8",
    "adaptive:c3sl:R=8,D=64,min_R=2 >> bwd:adaptive:c3sl:R=2,D=64"])
@pytest.mark.parametrize("mode", ["erasure", "retransmit"])
def test_link_erasure_draws_equal_reference(spec, mode):
    """Both directions' masks and info, step after step, while the
    adaptive controllers move R (the mask shape follows the bucket), and
    ChannelErasure at the same step: a host replay of the plan."""
    plan_kw = dict(seed=5, rates={"drop": 0.35, "bwd": {"corrupt": 0.2}})
    pol_kw = dict(mode=mode, max_erasure_frac=0.3, retry_budget=0)
    jl = jtransport.build_link(spec).install_faults(
        jfaults.FaultPlan(**plan_kw), jfaults.RecoveryPolicy(**pol_kw))
    tl = transport.build_link(spec).install_faults(
        faults.FaultPlan(**plan_kw), faults.RecoveryPolicy(**pol_kw))
    erasures = 0
    for step in range(12):
        try:
            want = jl.next_erasure(16)
        except jfaults.ChannelErasure as e:
            with pytest.raises(faults.ChannelErasure) as got:
                tl.next_erasure(16)
            assert (got.value.direction, got.value.step) == (e.direction, e.step)
            erasures += 1
        else:
            got = tl.next_erasure(16)
            assert got[1] == want[1]
            assert sorted(got[0]) == sorted(want[0])
            for k in want[0]:
                np.testing.assert_array_equal(got[0][k], want[0][k])
        snr = (5.0, -5.0)[step % 2]
        assert tl.observe(snr, snr) == jl.observe(snr, snr)
    assert 0 < erasures
