"""One run of one cell of the port's benchmark::

    python3 portbench/run.py --workload geotext-gcn.full --seed 7 --seconds 30 --trace 0

Prints the result as one JSON object on the last line of standard output:
``correct``, ``attempted`` (epochs in the window), ``failed`` (epochs whose
loss was not finite), ``metrics`` (with ``--trace 0`` the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compares, with its limit (also the last lines of standard
error). Exits non-zero, printing no result, without a CUDA device, when a
forbidden module (JAX, the JAX package) is loaded, or when the run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

T_IMPORTED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the World program's allocator setting (growable segments), as chip_smoke.py
# sets it, unless the caller set one
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        from portbench import harness

        t_start = T_IMPORTED - harness.process_age()
        spec = harness.load_spec(ROOT)
        chips = {w["name"]: w["chips"] for w in spec["workloads"]}.get(args.workload)
        if chips is None:
            print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
            return 2
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA device(s); torch.cuda.is_available() "
                  f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 2
        out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start)
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
