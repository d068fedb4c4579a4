"""Environment knobs read while a program is traced.

Every such knob is part of the jit cache key of the entry points that
read it (`trace_key`), so toggling one between same-shape calls retraces
instead of silently reusing the stale compiled program.
"""

import os

_TRACE_KNOBS = (
    ("KLT_SCAN_UNROLL", "1"),
    ("KLT_AFFINE_REPAIR_P", ""),
    ("KLT_AFFINE_REPAIR_M", ""),
    ("KLT_AFFINE_LADDER", ""),
    ("KLT_AFFINE_DEBUG_COUNTS", "0"),
)


def trace_key():
    """Fingerprint of the trace-time knobs, threaded through every jit
    entry point as a static argument."""
    return tuple(os.environ.get(k, d) for k, d in _TRACE_KNOBS)


def scan_unroll() -> int:
    """KLT_SCAN_UNROLL: unroll factor for the whole-sequence scans
    (bit-exact: the same body inlined N times; trades compile time and
    code size for less per-step scan glue)."""
    return max(1, int(os.environ.get("KLT_SCAN_UNROLL", "1")))


def precomp_pyramids() -> bool:
    """KLT_PRECOMP_PYR=1: build the whole chunk's pyramid stacks ahead
    of the tracking scan (fed via scan xs) instead of inside each step.
    Bit-exact (the same per-frame build program); costs O(T) resident
    stack memory, so it stays opt-in for unbounded streaming."""
    return os.environ.get("KLT_PRECOMP_PYR", "0") == "1"
