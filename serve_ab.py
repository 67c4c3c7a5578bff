#!/usr/bin/env python3
"""A/B readings of the port's serving phase on one GPU.

    python3 serve_ab.py DIR_A DIR_B [--rounds 2]

DIR_A and DIR_B are checkouts of the repository (for example a parent
commit unpacked with ``git archive`` and the working tree ``.``). Each
round runs A, B, B, A, so that a drift over the run falls on both
alike. Every run is a process of its own, started in its checkout's
root: it builds that checkout's kernels and runs that checkout's
``chip_smoke.serving_phase`` (gpt3_1p3b at full width, 9 requests, 64
new tokens each, every token checked). Prints each run's serving record
as one JSON line tagged with its checkout and round, then one line with
the median tokens/s, TTFT and TPOT of each checkout. Exits non-zero if
a run fails.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = """
import sys, torch
sys.path.insert(0, ".")
import chip_smoke
from paddle_tpu_torch.ops import _build
if not torch.cuda.is_available():
    sys.exit("serve_ab: no CUDA device")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build_all()
chip_smoke.serving_phase(torch, torch.device("cuda", 0))
"""

_KEYS = ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "wall_s")


def run_one(root, timeout):
    out = subprocess.run([sys.executable, "-c", _CHILD], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    recs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    serve = [r for r in recs if r.get("phase") == "serving_gpt3_1p3b"]
    if out.returncode or not serve:
        sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
        raise SystemExit(f"serve_ab: run in {root} failed "
                         f"(rc {out.returncode})")
    return serve[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=300.0)
    args = ap.parse_args()
    roots = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    got = {"a": [], "b": []}
    for rnd in range(args.rounds):
        for tag in ("a", "b", "b", "a"):
            rec = run_one(roots[tag], args.timeout)
            got[tag].append(rec)
            print(json.dumps({"serve_ab": tag, "root": roots[tag],
                              "round": rnd,
                              **{k: rec[k] for k in _KEYS},
                              "ok": rec["ok"]}), flush=True)
    print(json.dumps({"serve_ab_medians": {
        tag: {"runs": len(recs), **{k: statistics.median(r[k] for r in recs)
                                    for k in _KEYS}}
        for tag, recs in got.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
