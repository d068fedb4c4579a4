"""Profiling utilities: the JAX counterpart of the reference's gprof/nsys
toolchain (src/V1/Makefile:76-91, src/V4/Makefile:100-103).

Two layers:
* `trace(...)` — context manager around `jax.profiler` producing an
  xplane/perfetto trace directory;
* `op_breakdown(...)` — parses the perfetto JSON trace and aggregates
  on-device op time by (source line, HLO category), the moral
  equivalent of a gprof flat profile for the compiled XLA program.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax profiler trace around the with-block."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _latest_trace_json(log_dir: str) -> str:
    paths = glob.glob(os.path.join(log_dir, "**", "*.trace.json.gz"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .trace.json.gz under {log_dir}")
    return max(paths, key=os.path.getmtime)


def op_breakdown(log_dir: str, runs: int = 1, top: int = 30):
    """[(us_per_run, count_per_run, category, source), ...] sorted by time.

    SELF-time accounting on the GPU's stream tracks (process
    "/device:GPU:<n>", threads "Stream #<id>(...)"): each event is
    charged its duration minus its nested children's, so containers
    contribute only their own time and every kernel, custom calls
    included, is counted once.  A trace without a GPU device track is
    an error.
    """
    with gzip.open(_latest_trace_json(log_dir)) as f:
        t = json.load(f)
    ev = t["traceEvents"]
    pids = {}
    tnames = {}
    for e in ev:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pids[e["pid"]] = e["args"].get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "thread_name":
            tnames[(e["pid"], e["tid"])] = e["args"].get("name", "")
    dev = {p for p, nm in pids.items() if nm.startswith("/device:GPU:")}
    if not dev:
        raise ValueError(f"no GPU device track in {log_dir}; processes: "
                         f"{sorted(set(pids.values()))}")

    tracks = collections.defaultdict(list)
    for e in ev:
        if e.get("ph") != "X" or "dur" not in e or e.get("pid") not in dev:
            continue
        tname = tnames.get((e["pid"], e["tid"]), "")
        if not tname.startswith("Stream"):
            continue  # module and annotation tracks mirror kernel time
        tracks[(e["pid"], e.get("tid"))].append(e)

    agg = collections.Counter()
    cnt = collections.Counter()

    def account(e, child_dur):
        self_t = max(e["dur"] - child_dur, 0.0)
        a = e.get("args", {})
        key = (a.get("hlo_category", "?"),
               a.get("source", e.get("name", "")))
        agg[key] += self_t
        cnt[key] += 1

    for tr in tracks.values():
        tr.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # [end_ts, child_dur, event]

        def close_until(ts):
            while stack and stack[-1][0] <= ts + 1e-9:
                _, ch, pe = stack.pop()
                account(pe, ch)
                if stack:
                    stack[-1][1] += pe["dur"]

        for e in tr:
            close_until(e["ts"])
            stack.append([e["ts"] + e["dur"], 0.0, e])
        close_until(float("inf"))

    rows = [(d / runs, cnt[k] / runs, k[0], k[1])
            for k, d in agg.most_common(top)]
    return rows


def print_breakdown(log_dir: str, runs: int = 1, top: int = 30) -> None:
    for us, n, cat, src in op_breakdown(log_dir, runs, top):
        print(f"{us:9.1f} us  n={n:7.1f}  {cat[:22]:22s} {src}")
