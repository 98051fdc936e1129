"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size (not run by the benchmark's runs)::

    python3 portbench/calibrate.py --workload twitter-world-gcn.full --seeds 11 12 13 \
        --controls tf32 fp8 half
    python3 portbench/calibrate.py --workload geotext-gcn.full --config geotext-gcn \
        --traffic full_30 --seeds 11 12 13 --controls tf32 half

Runs a cell of ``BENCHMARK.json``, or one named by its configuration and
traffic files (its limits file is ``limits/<workload>.json``). For each seed:
set-up and the check job exactly as a run makes them (no
window), the program's state freed, the reference; then each control, the
reference put in the program's place and compared with the reference by
the same numbers. The configuration's family (``families/<family>.py``)
names its controls (``CONTROLS``) and runs them; the Highway-GCN's:

- ``tf32``: the GEMMs in TF32 (the configuration states float32, TF32 off);
- ``fp8``: the configuration's stated bf16 roundings in e4m3 instead;
- ``half``: a planted fault, half of the training rows left out and the mean
  taken over the rest.

(A step that leaves the state unchanged reads 1 on ``delta_gap`` by
definition and needs no run.) One JSON line a seed and reading on standard
output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def readings_for_seed(workload: str, seed: int, controls, *, device: str = "cuda",
                      config=None, traffic=None, override=None) -> list:
    """[(kind, readings)] for one seed: ("program", ...) then each
    control's. ``config`` and ``traffic`` name the cell's files where the
    workload is not a cell of ``BENCHMARK.json``."""
    from portbench import harness

    if config is None or traffic is None:
        wl = {w["name"]: w for w in harness.load_spec()["workloads"]}[workload]
        config, traffic = wl["config"], wl["traffic"]
    config = harness.load_file(harness.BENCH_DIR, "configs", config)
    traffic = harness.load_file(harness.BENCH_DIR, "traffic", traffic)
    cell = harness.build(config, traffic, seed, device, override)
    family = cell.family
    unknown = sorted(set(controls) - set(family.CONTROLS))
    if unknown:
        raise harness.RunError(f"controls {unknown} are not among the family's {family.CONTROLS}")
    harness.check_perm(cell.perm, cell.inputs.n)
    steps = traffic["check_steps"]
    w0 = family.initial_weights(cell.weights, seed, device)
    cap = harness.Capture(cell, w0, steps)
    harness.run_job(cell)
    prog = cap.close()
    harness.free_program(cell)
    problem = family.reference_problem(cell)
    ref = family.reference_readings(problem, w0, device, steps)
    out = [("program", family.check_numbers(cell, prog, ref))]
    for kind in controls:
        out.append((kind, family.readings(family.control(kind, problem, w0, device, steps),
                                          ref)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--config", help="the configuration file's name, for a cell not in "
                   "BENCHMARK.json (with --traffic)")
    p.add_argument("--traffic", help="the traffic file's name, for such a cell")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", nargs="*", default=[],
                   help="the family's controls to run (the Highway-GCN's: tf32 fp8 half)")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("calibrate.py reads the card: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for kind, r in readings_for_seed(args.workload, seed, args.controls,
                                         config=args.config, traffic=args.traffic):
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind, **r}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
