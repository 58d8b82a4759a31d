"""The in-trace check fails where a trace cannot be trusted: records kept
as the profiler gives them, never clipped to the span."""

import pytest

from mosaicbench.trace import TOL_S, Trace

K = "warp_plane_kernel"


def _trace(ops, wall=1.0, events=0.99, placed=True):
    return Trace(wall, events, ops, [], placed)


def test_a_sound_trace_passes():
    tr = _trace([(K, 0.01, 0.2), ("memcpy", 0.1, 0.3), (K, 0.5, 0.9)])
    assert tr.faults([K]) == []
    assert tr.busy_s == pytest.approx(0.69)


@pytest.mark.parametrize("ops, events, placed, what", [
    ([(K, -0.01, 0.2)], 0.99, True, "before the span"),
    ([(K, 0.5, 1.0 + 2 * TOL_S)], 0.99, True, "after the span"),
    ([(K, 0.0, 0.5), ("memcpy", 0.5, 0.99)], 0.6, True, "busy"),
    ([(K, 0.0, 0.4), (K, 0.1, 0.5), (K, 0.2, 0.6)], 0.8, True,
     "add up to"),
    ([(K, 0.1, 0.2)], 0.99, False, "cannot be placed"),
    ([], 0.99, True, "busy"),
])
def test_a_trace_that_cannot_be_trusted_fails(ops, events, placed, what):
    faults = _trace(ops, events=events, placed=placed).faults([K])
    assert any(what in f for f in faults), faults
