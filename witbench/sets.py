"""Runs of one cell, each a process of its own, and the spread of each
metric: how the bounds and the correctness readings are measured.

    python3 witbench/sets.py --workload mk32.run --seeds 11,12,13 \
        [--seconds 10] [--trace 0|1] [--control] [--out DIR]

Each run is `python3 witbench/run.py ...` with one seed, in turn; its
standard output and error are written under --out when given.  Printed:
each run's result line in short (correct, the metrics, the numbers
compared), then each metric's values, median and spread, the distance
between the first and third quartiles of statistics.quantiles(n=4) as a
share of the median.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def last_json(text):
    for line in reversed(text.strip().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return None


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", default="10")
    ap.add_argument("--trace", default="0")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    out = Path(a.out) if a.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    values = {}
    for seed in a.seeds.split(","):
        cmd = [sys.executable, str(RUN), "--workload", a.workload, "--seed",
               seed, "--seconds", a.seconds, "--trace", a.trace]
        if a.control:
            cmd += ["--control", "1"]
        t = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.perf_counter() - t
        tag = f"{a.workload}.s{seed}.t{a.trace}{'.c' if a.control else ''}"
        if out:
            (out / f"{tag}.out").write_text(r.stdout)
            (out / f"{tag}.err").write_text(r.stderr)
        res = last_json(r.stdout)
        if res is None:
            print(f"{tag} rc={r.returncode} wall={wall:.1f}s NO RESULT; "
                  f"stderr tail: {r.stderr[-1500:]}", flush=True)
            continue
        short = {k: v["value"] for k, v in res.get("metrics", {}).items()}
        cmp_ = {k: v["value"] for k, v in res.get("compared", {}).items()}
        dev = {k: v for k, v in res.get("device", {}).items()
               if k != "kind"}
        print(f"{tag} rc={r.returncode} wall={wall:.1f}s correct="
              f"{res.get('correct')} batches={res.get('batches')} "
              f"batch_ms={json.dumps(res.get('batch_ms'))} "
              f"metrics={json.dumps(short)} compared={json.dumps(cmp_)} "
              f"device={json.dumps(dev)}", flush=True)
        if "breakdown" in res:
            print(f"  breakdown {json.dumps(res['breakdown'])}", flush=True)
        for k, v in short.items():
            values.setdefault(k, []).append(v)
    for k, v in values.items():
        line = f"{k}: n={len(v)} median={statistics.median(v)!r}"
        if len(v) >= 2:
            q1, _, q3 = statistics.quantiles(v, n=4)
            line += f" spread={(q3 - q1) / statistics.median(v):.5f}"
        print(line + f" values={v}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
