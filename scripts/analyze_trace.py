"""Summarize a jax.profiler perfetto trace: device time by HLO op category.

Pairs with scripts/profile_wave.py (which writes perfetto_trace.json.gz
under <trace-dir>/plugins/profile/). Groups the GPU tracks' complete
events by a coarse op-family key so the wave cost attribution is one
table instead of a TensorBoard session.

    python scripts/analyze_trace.py traces/wave [--top 40]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re


def find_trace(root: str) -> str:
    hits = sorted(
        glob.glob(os.path.join(root, "**", "*perfetto_trace.json.gz"), recursive=True),
        key=os.path.getmtime,
    )
    if not hits:
        raise SystemExit(f"no perfetto_trace.json.gz under {root}")
    return hits[-1]


def family(name: str) -> str:
    """Coarse op-family key from an HLO/kernel event name."""
    n = name.lower()
    for pat, fam in (
        (r"fusion", "fusion"),
        (r"custom-call|triton", "custom-kernel"),
        (r"convolution|conv|fprop|cudnn", "conv"),
        (r"\bdot\b|dot_general|matmul|gemm", "dot"),
        (r"scatter", "scatter"),
        (r"gather", "gather"),
        (r"dynamic-slice|dynamic_slice", "dynamic-slice"),
        (r"dynamic-update-slice|dynamic_update", "dynamic-update-slice"),
        (r"while", "while"),
        (r"sort|top-k|topk|approx", "sort/topk"),
        (r"reduce", "reduce"),
        (r"copy|transpose|bitcast|reshape", "copy/layout"),
        (r"rng|random", "rng"),
        (r"select|compare|broadcast|iota|convert|add|mul", "elementwise"),
    ):
        if re.search(pat, n):
            return fam
    return "other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument(
        "--track-regex",
        default="/device:GPU|Stream",
        help="process/thread name filter for device tracks",
    )
    a = ap.parse_args()

    path = find_trace(a.trace_dir)
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data

    # Map (pid, tid) -> names from metadata events.
    proc = {}
    thread = {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                proc[e["pid"]] = e["args"].get("name", "")
            elif e.get("name") == "thread_name":
                thread[(e["pid"], e.get("tid"))] = e["args"].get("name", "")

    track_re = re.compile(a.track_regex, re.I)

    def on_device(e):
        p = proc.get(e.get("pid"), "")
        t = thread.get((e.get("pid"), e.get("tid")), "")
        return bool(track_re.search(p) or track_re.search(t))

    by_fam = collections.Counter()
    by_name = collections.Counter()
    count_name = collections.Counter()
    total = 0.0
    tracks = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if not on_device(e):
            continue
        dur = float(e["dur"])  # microseconds
        name = e.get("name", "?")
        tracks[
            f"{proc.get(e.get('pid'), '?')}/{thread.get((e.get('pid'), e.get('tid')), '?')}"
        ] += dur
        by_fam[family(name)] += dur
        by_name[name] += dur
        count_name[name] += 1
        total += dur

    print(f"trace: {path}")
    print(f"device-track total: {total / 1e3:.1f} ms\n")
    print("== tracks ==")
    for t, d in tracks.most_common(8):
        print(f"{d / 1e3:10.1f} ms  {t}")
    print("\n== by op family ==")
    for fam, d in by_fam.most_common():
        print(f"{d / 1e3:10.1f} ms  {100 * d / max(total, 1):5.1f}%  {fam}")
    print(f"\n== top {a.top} ops ==")
    for name, d in by_name.most_common(a.top):
        print(
            f"{d / 1e3:10.1f} ms  {100 * d / max(total, 1):5.1f}%  x{count_name[name]:<6} {name[:110]}"
        )


if __name__ == "__main__":
    main()
