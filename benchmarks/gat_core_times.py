"""Device time of one application of the tiled GAT layer, forward and
backward, in a cell of the port's benchmark (``BENCHMARK.json``)::

    python3 benchmarks/gat_core_times.py [--workload twitter-world-gat.full] [--seed 7]

Builds the cell as ``portbench/run.py`` does, runs one job of its mix to
warm up, then one job under ``torch.profiler``, and prints for the layer's
autograd Function (``ops/attention_tiled.py :: _TiledGatCore``) and for its
``_TiledGatCoreBackward``: the applications (outermost runs), the device
time of everything launched under them in all and per application (as
``portbench/metrics/attn_roofline.py`` reads them), and that time by kernel.
Needs a CUDA device; reads the benchmark's files of the checkout it lies in.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPERATOR = "_TiledGatCore"
BACKWARD = OPERATOR + "Backward"


def kernels_under(events) -> collections.Counter:
    """Device seconds by kernel name of the kernels launched under
    ``events`` and their host children."""
    total = collections.Counter()
    stack = list(events)
    while stack:
        e = stack.pop()
        for k in getattr(e, "kernels", []):
            total[k.name[:90]] += k.duration * 1e-6
        stack.extend(e.cpu_children)
    return total


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="twitter-world-gat.full")
    p.add_argument("--seed", type=int, default=7)
    args = p.parse_args(argv)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness

    spec = harness.load_spec(ROOT)
    wl = {w["name"]: w for w in spec["workloads"]}[args.workload]
    config = harness.load_file(harness.BENCH_DIR, "configs", wl["config"])
    traffic = harness.load_file(harness.BENCH_DIR, "traffic", wl["traffic"])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"{args.workload}, seed {args.seed}, torch {torch.__version__}, card {card}")
    cell = harness.build(config, traffic, args.seed, "cuda")
    harness.run_job(cell)
    traced = harness.traced_job(cell)
    tr = traced["trace"]
    print(f"traced job: {traced['epochs']} epochs in {traced['wall_s']!r} s, device busy "
          f"{tr.busy_s()!r} s")
    for name, match in (("forward", lambda s: OPERATOR in s and BACKWARD not in s),
                        ("backward", lambda s: BACKWARD in s)):
        runs = tr._outermost(match)
        seconds = tr.op_device_seconds(match)
        each = 1e3 * seconds / max(len(runs), 1)
        print(f"{name}: {len(runs)} applications, {seconds!r} s on the device, {each!r} ms each")
        for kernel, sec in kernels_under(runs).most_common(8):
            print(f"  {1e3 * sec / max(len(runs), 1)!r} ms each  {kernel}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
