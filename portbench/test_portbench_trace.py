"""The trace reduction: device busy time as a union of intervals inside the
window, and idle gaps labelled by the innermost span open at their middle."""
import pytest

from portbench.trace import Span, summarise, union


def test_union_merges_overlaps():
    assert union([(5, 7), (0, 2), (1, 3), (7, 9)]) == [(0, 3), (5, 9)]


def test_busy_time_is_clipped_to_the_window_and_counted_once():
    events = [("a", 0, 40), ("b", 30, 60), ("a", 80, 200)]
    s = summarise(events, 10, 100, [], [])
    assert s.window_s == pytest.approx(90e-9)
    assert s.busy_s == pytest.approx((60 - 10 + 100 - 80) * 1e-9)
    assert s.device_ops[0][0] == "a"
    assert s.device_ops[0][1] == pytest.approx((40 - 10 + 100 - 80) * 1e-9)


def test_idle_gaps_take_the_innermost_program_span_then_the_harness_span():
    events = [("k", 0, 10), ("k", 50, 60), ("k", 90, 100)]
    prog = [Span(5, 70, "query"), Span(20, 40, "store.read")]
    harness = [Span(0, 100, "client.call")]
    s = summarise(events, 0, 100, prog, harness)
    gaps = dict(s.idle_gaps)
    assert gaps["store.read"] == pytest.approx(40e-9)     # the gap 10..50, middle 30
    assert gaps["client.call"] == pytest.approx(30e-9)    # the gap 60..90, middle 75
    assert s.busy_s + sum(gaps.values()) == pytest.approx(s.window_s)


def test_device_op_names_lose_return_type_and_arguments():
    from portbench.trace import short_name
    assert short_name("void at::native::k<128, 8, f(int)>(int, float*)") == \
        "at::native::k<128, 8, f(int)>"
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert short_name("(anonymous namespace)::probe_append_kernel(int const*)") == \
        "(anonymous namespace)::probe_append_kernel"


def test_a_name_in_an_anonymous_namespace_keeps_its_kernel():
    from portbench.trace import short_name
    assert short_name("void at::cuda::(anonymous namespace)::spin_kernel(long)") == \
        "at::cuda::(anonymous namespace)::spin_kernel"


@pytest.mark.parametrize("found", [[1010, 5008], [1010], [5008]])
def test_the_clock_offset_survives_a_lost_marker(found):
    from portbench.trace import _clock_offset
    host_marks = [1000, 5000]                  # before and after the window [1100, 4900]
    intervals = [(1200, 1300), (2000, 2600), (4500, 4800)]
    off = _clock_offset(found, host_marks, intervals, 1100, 4900)
    assert off in (10, 8)
