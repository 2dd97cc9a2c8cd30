"""``repro_torch.kernels.trace.between_markers``: which profiler traces
count as complete.  The profiler loses whole traces or their first
events, never a kernel between two it kept, so a trace is complete when
it holds one or both leading markers in a row and ends with the
trailing one; the events between them are the traced call's, and those
before them (a prelude, or what it left of one) are dropped."""

import pytest

from repro_torch.kernels.trace import LEADING, Event, between_markers


def _ev(name: str) -> Event:
    if name == "M":
        name = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    return Event(name, "kernel", (1, 1, 1), 1.0)


@pytest.mark.parametrize("names,want", [
    ("M M a b M", "a b"),                 # complete
    ("M a b M", "a b"),                   # the first kernel lost
    ("M M M", ""),                        # a call that launched nothing
    ("a b M", None),                      # both leading markers lost
    ("", None),                           # the whole trace lost
    ("M M a b", None),                    # the trailing marker lost
    ("M a M b M", None),                  # a marker inside the window
    ("M M M a M", None),                  # more leading markers than run
    ("p q M M a b M", "a b"),             # after a prelude
    ("q M a M", "a"),                     # a prelude and a marker lost
    ("p q a M", None),                    # both markers after it lost
])
def test_a_trace_is_complete_between_its_markers(names, want):
    assert LEADING == 2
    got = between_markers([_ev(n) for n in names.split()])
    assert (got if got is None else [e.name for e in got]) == (
        want if want is None else want.split())
