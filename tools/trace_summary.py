"""Device busy share and heaviest device events of a jax.profiler trace.

    python bench.py --trace DIR        # on a GPU: trace the measured loop
    python tools/trace_summary.py DIR

For each GPU stream in the newest trace under DIR, prints the event count,
the busy time (union of event intervals) against the span from the first
event's start to the last one's end, and the twelve events with the most
device time.
"""

from __future__ import annotations

import argparse
import glob


def summarize(trace_dir: str, top: int = 12) -> None:
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise SystemExit(f"no trace under {trace_dir}")
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = sorted((e.start_ns, e.duration_ns, e.name) for e in line.events)
            if not evs:
                continue
            busy, end = 0.0, -1.0
            for s0, d, _ in evs:
                if s0 + d > end:
                    busy += s0 + d - max(s0, end)
                    end = s0 + d
            span = max(s0 + d for s0, d, _ in evs) - evs[0][0]
            print(f"# {plane.name} | {line.name}: {len(evs)} events, busy "
                  f"{busy / 1e6:.3f} ms of span {span / 1e6:.3f} ms")
            tot: dict[str, list] = {}
            for _, d, name in evs:
                acc = tot.setdefault(name, [0.0, 0])
                acc[0] += d
                acc[1] += 1
            for name, (d, n) in sorted(tot.items(), key=lambda kv: -kv[1][0])[:top]:
                print(f"#   {d / 1e6:9.3f} ms {n:6d}x  {name[:110]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    summarize(args.trace_dir, args.top)


if __name__ == "__main__":
    main()
