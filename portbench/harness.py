"""The benchmark of the PyTorch and CUDA port (``graphconvgeo_torch``): one
run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; each is a file of its own, found by name:
``configs/<config>.json`` (the model's family, its fields, the operator, the
generator and its parameters), ``traffic/<traffic>.json`` (the trainer, the
job length, the steps the check follows), ``limits/<workload>.json`` (the
limit of each number ``correct`` compares) and, for each per-layer metric,
``metrics/<metric>.py`` (a ``read(record)`` that returns its number, or None
where it finds nothing to read). Everything that depends on the model is in
``families/<family>.py`` (see :func:`load_family`), so this file names no
model.

A run: make the inputs from the seed; the port's data layer for a
materialized Â (``data_s``); the family's model on its operands, and the
trainer (``operands_s``); the benchmark's weights, made on the device from
the seed by the family and loaded into the model; one job of the mix
through the trainer's ``fit``
(it builds and loads every kernel, warms every shape up, and its first steps
are what the check compares); then the window: jobs back to back until
``--seconds`` have passed, the job in flight finishing. ``--trace 1`` adds
one profiled job. After the window the program's state is freed and the
plain reference follows the first steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "graphconvgeo_tpu")
BETA1 = 0.9  # torch.optim.Adam's default, the trainers' optimizer
# what a family file provides (load_family)
FAMILY_API = ("build", "weight_spec", "initial_weights", "shapes", "counts", "program_layout",
              "describe", "reference_problem", "reference_readings", "check_numbers",
              "CONTROLS", "control", "readings")


class RunError(RuntimeError):
    """A run that cannot print a result."""


def load_spec(root: str = ROOT) -> dict:
    """``BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_file(bench_dir: str, kind: str, name: str) -> dict:
    """``<bench_dir>/<kind>/<name>.json``."""
    with open(os.path.join(bench_dir, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(bench_dir: str, kind: str, name: str):
    """``<bench_dir>/<kind>/<name>.py``, loaded by its path."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(bench_dir: str, name: str):
    """The ``read`` function of ``<bench_dir>/metrics/<name>.py``."""
    return load_module(bench_dir, "metrics", name).read


def load_family(bench_dir: str, config: dict):
    """``<bench_dir>/families/<family>.py`` of the configuration's
    ``"family"``, which every configuration names. A family file provides:

    - ``build(config, inputs, ds, model_fields, seed, device)``: the port's
      model on its operands, from the inputs and the data layer's ``ds``
      (None where the configuration's Â is not materialized);
    - ``weight_spec(model)`` and ``initial_weights(spec, seed, device)``:
      the benchmark's initial weights from the seed, once with the model
      built and again once it is freed;
    - ``shapes(config, inputs, ds, model)``: the record's model-specific
      shapes; ``counts(config, shapes)``: keys merged into the traced
      record, for the per-layer metrics;
    - ``program_layout(model)``: the program's operand layout, judged by
      ``check_numbers``; ``describe(cell)``: the set-up line's words;
    - ``reference_problem(cell)``, ``reference_readings(problem, w0, device,
      steps)``, ``check_numbers(cell, prog, ref)``: the check;
      ``CONTROLS``, ``control(kind, problem, w0, device, steps)`` and
      ``readings(other, ref)``: its controls (``calibrate.py``)."""
    name = config.get("family")
    if not isinstance(name, str) or not re.fullmatch(r"[A-Za-z0-9_]+", name):
        raise RunError(f"configuration {config.get('name')!r} names no family "
                       f"(its \"family\" key: {name!r})")
    if not os.path.isfile(os.path.join(bench_dir, "families", f"{name}.py")):
        raise RunError(f"no family {name!r} in {bench_dir}/families")
    family = load_module(bench_dir, "families", name)
    missing = [a for a in FAMILY_API if not hasattr(family, a)]
    if missing:
        raise RunError(f"family {name!r} lacks {missing}")
    return family


def cell_metrics(spec: dict, workload: str, kind: str) -> list:
    """The ``kind`` metrics ("end_to_end" or "per_layer") a cell reports."""
    return [m for m in spec[kind] if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    """Top-level module names in ``sys.modules`` that a run must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (from /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True,
        ).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---- set-up -------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """What set-up built: the program's objects and the benchmark's own."""

    config: dict
    traffic: dict
    family: object  # the configuration's family module (load_family)
    seed: int
    device: str
    inputs: object
    perm: np.ndarray  # program row -> benchmark row (the port's reordering)
    model: object
    trainer: object
    fit_args: tuple
    fit_kwargs: dict
    spans: dict
    shapes: dict
    layout: dict  # the program's operand layout, read only to be judged by the check
    weights: object  # the family's weight_spec of the model
    model_fields: dict  # the configuration's model fields as built


@contextlib.contextmanager
def span(spans: dict, name: str, device):
    sync(device)
    t0 = time.perf_counter()
    yield
    sync(device)
    spans[name] = time.perf_counter() - t0


def build(config: dict, traffic: dict, seed: int, device: str = "cuda",
          override: Optional[dict] = None, bench_dir: str = BENCH_DIR) -> Cell:
    """Make the inputs and drive the port's set-up (see the module
    docstring). ``override`` replaces generator parameters and model fields
    (the tests' small sizes: keys "generator_params" and "model")."""
    import torch

    from graphconvgeo_torch.train.trainer import TrainConfig, Trainer

    from portbench.problems import make_inputs

    family = load_family(bench_dir, config)
    override = override or {}
    if torch.device(device).type == "cuda":
        torch.zeros(1, device=device)  # the CUDA context, before the spans
    inputs = make_inputs(config, seed, override.get("generator_params"))
    n = inputs.n
    spans: dict = {}
    perm = np.arange(n, dtype=np.int64)
    materialized = config["adjacency"] == "materialized"
    with span(spans, "data", device):
        ds = None
        if materialized:
            from graphconvgeo_torch.data.pipeline import Dataset
            from graphconvgeo_torch.sparse.factorized import materialize_projection
            from graphconvgeo_torch.sparse.formats import normalize_adjacency

            adj = normalize_adjacency(materialize_projection(
                dict(enumerate(inputs.groups)), n,
                direct=(inputs.direct_src, inputs.direct_dst)))
            offsets, members = inputs.groups_csr()
            ds = Dataset(x=inputs.x, adj=adj, y=inputs.y, train_idx=inputs.train_idx,
                         dev_idx=inputs.dev_idx, test_idx=inputs.test_idx, lat=inputs.lat,
                         lon=inputs.lon, class_lat_median=inputs.class_lat_median,
                         class_lon_median=inputs.class_lon_median, groups_offsets=offsets,
                         groups_members=members, direct_src=inputs.direct_src,
                         direct_dst=inputs.direct_dst)
            if config.get("reorder", False):
                ds, ro = ds.reorder()
                perm = np.asarray(ro.perm, np.int64)
    src = ds if ds is not None else inputs
    with span(spans, "operands", device):
        model_fields = {**config["model"], **override.get("model", {})}
        model = family.build(config, inputs, ds, model_fields, seed, device)
        job = traffic["job_epochs"]
        tcfg = TrainConfig(learning_rate=config["lr"], epochs=job, patience=job,
                           min_epochs=job, seed=seed, verbose=False)
        if traffic["trainer"] != "full":
            raise RunError(f"unknown trainer {traffic['trainer']!r}")
        trainer = Trainer(model, tcfg)
    weights = family.weight_spec(model)
    model.load_state_dict(family.initial_weights(weights, seed, device))
    layout = family.program_layout(model)
    fit_args = (np.asarray(src.y), np.asarray(src.train_idx), np.asarray(src.dev_idx))
    fit_kwargs = dict(lat=np.asarray(src.lat), lon=np.asarray(src.lon),
                      class_lat_median=np.asarray(src.class_lat_median),
                      class_lon_median=np.asarray(src.class_lon_median))
    memberships = int(sum(len(g) for g in inputs.groups))
    shapes = {"n": n, "vocab": inputs.x.shape[1], "classes": inputs.n_classes,
              "x_nnz": int(inputs.x.nnz), "groups": len(inputs.groups),
              "memberships": memberships, "train": len(inputs.train_idx),
              **family.shapes(config, inputs, ds, model)}
    return Cell(config=config, traffic=traffic, family=family, seed=seed, device=device,
                inputs=inputs, perm=perm, model=model, trainer=trainer, fit_args=fit_args,
                fit_kwargs=fit_kwargs, spans=spans, shapes=shapes, layout=layout,
                weights=weights, model_fields=model_fields)


def run_job(cell: Cell) -> dict:
    """One training job of the mix: the trainer's ``fit``."""
    return cell.trainer.fit(*cell.fit_args, **cell.fit_kwargs)


class Capture:
    """Records the first ``steps`` steps of the next job: each step's loss
    (as the trainer's step returns it), each parameter's first gradient as
    the optimizer gets it (from Adam's first moment after one step) and each
    parameter's change after the steps."""

    def __init__(self, cell: Cell, w0: dict, steps: int):
        import torch

        self.cell, self.w0, self.steps = cell, w0, steps
        self.losses, self.g1, self.delta = [], {}, {}
        self.g1_tensors = {}
        self.count = 0
        trainer = cell.trainer
        self.names = {id(p): name for name, p in cell.model.named_parameters()}
        self._norm = lambda t: torch.linalg.vector_norm(t, dtype=torch.float64)
        self._hook = trainer.optimizer.register_step_post_hook(self._post)
        step = trainer.train_step

        def recorded_step(*args, **kwargs):
            loss = step(*args, **kwargs)
            if len(self.losses) < self.steps:
                self.losses.append(loss.detach().clone())
            return loss

        trainer.train_step = recorded_step

    def _post(self, opt, args, kwargs):
        self.count += 1
        if self.count == 1:
            for group in opt.param_groups:
                for p in group["params"]:
                    g = opt.state[p]["exp_avg"] / (1.0 - BETA1)
                    self.g1[self.names[id(p)]] = self._norm(g)
                    self.g1_tensors[self.names[id(p)]] = g.float().cpu()
        if self.count == self.steps:
            for group in opt.param_groups:
                for p in group["params"]:
                    name = self.names[id(p)]
                    self.delta[name] = self._norm(p.detach() - self.w0[name])

    def close(self) -> dict:
        self._hook.remove()
        del self.cell.trainer.train_step
        if self.count < self.steps:
            raise RunError(f"the check job made {self.count} steps, not {self.steps}")
        return {"losses": [float(t) for t in self.losses],
                "g1": {k: float(v) for k, v in self.g1.items()},
                "delta": {k: float(v) for k, v in self.delta.items()},
                "g1_tensors": self.g1_tensors}


def window(cell: Cell, seconds: float) -> dict:
    """Jobs back to back until ``seconds`` have passed (the job in flight
    finishes): the wall, jobs, epochs, steps and non-finite losses."""
    sync(cell.device)
    t0 = time.perf_counter()
    jobs = epochs = bad = 0
    ends = []
    while True:
        out = run_job(cell)
        jobs += 1
        epochs += len(out["history"])
        bad += sum(not math.isfinite(h["loss"]) for h in out["history"])
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync(cell.device)
    job_s = [b - a for a, b in zip([0.0] + ends[:-1], ends)]
    return {"wall_s": time.perf_counter() - t0, "jobs": jobs, "epochs": epochs,
            "nonfinite": bad, "job_ms": [round(t * 1e3, 1) for t in job_s]}


def traced_job(cell: Cell) -> dict:
    """One job under ``torch.profiler`` (host and card): its wall, epochs,
    kernel launches by name (the port's counter) and the parsed trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.traceread import Trace

    activities = [ProfilerActivity.CPU]
    if torch.device(cell.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sync(cell.device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        out = run_job(cell)
        sync(cell.device)
        wall = time.perf_counter() - t0
    launches: dict = {}
    for h in out["history"]:
        for k, v in h["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"wall_s": wall, "epochs": len(out["history"]), "launches": launches,
            "trace": Trace(prof)}


# ---- the check ----------------------------------------------------------


def check_perm(perm: np.ndarray, n: int) -> None:
    """The reordering the reference follows must be a relabeling."""
    if perm.shape != (n,) or not np.array_equal(np.sort(perm), np.arange(n)):
        raise RunError("the port's reordering is not a permutation of the nodes")


def free_program(cell: Cell) -> None:
    import torch

    cell.model = cell.trainer = None
    gc.collect()
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ---- one run ------------------------------------------------------------


def run(workload: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
        root: str = ROOT, bench_dir: str = BENCH_DIR, override: Optional[dict] = None,
        t_start: Optional[float] = None, sabotage=None, spec: Optional[dict] = None) -> dict:
    """One run of a cell; returns the result line's object. ``sabotage``
    (tests only) is called with the built cell before its check job, to
    break the timed path; ``spec`` replaces ``BENCHMARK.json`` (tests: a
    cell that the benchmark does not hold)."""
    import torch

    t_start = time.perf_counter() - process_age() if t_start is None else t_start
    spec = spec or load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    wl = cells[workload]
    config = load_file(bench_dir, "configs", wl["config"])
    traffic = load_file(bench_dir, "traffic", wl["traffic"])
    limits = load_file(bench_dir, "limits", workload)
    on_card = torch.device(device).type == "cuda"

    cell = build(config, traffic, seed, device, override, bench_dir)
    family = cell.family
    check_perm(cell.perm, cell.inputs.n)
    if sabotage is not None:
        sabotage(cell)
    w0 = family.initial_weights(cell.weights, seed, device)
    cap = Capture(cell, w0, traffic["check_steps"])
    run_job(cell)
    prog = cap.close()
    del w0
    sync(device)
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    print(f"cell {workload}: shapes {cell.shapes}, {family.describe(cell)}, set-up spans "
          f"{cell.spans}, set-up {setup_s!r} s", file=sys.stderr)
    win = window(cell, seconds)
    print(f"window: {win}", file=sys.stderr)
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    traced = traced_job(cell) if trace else None
    peak = max(peak_setup, peak_window, torch.cuda.max_memory_allocated() if on_card else 0)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded in the run's process: {found}")

    result_metrics = {}
    epoch_s = win["wall_s"] / max(win["epochs"], 1)
    if not trace:
        values = {"setup_s": setup_s, "epoch_ms": epoch_s * 1e3}
        for m in cell_metrics(spec, workload, "end_to_end"):
            if m["name"] not in values:
                raise RunError(f"end-to-end metric {m['name']!r} is not measured here")
            result_metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = traced["trace"]
        counts = family.counts(config, cell.shapes)
        record = {
            "workload": workload, "config": config, "traffic": traffic, "shapes": cell.shapes,
            "spans": dict(cell.spans), "window": win, "epoch_s": epoch_s,
            "memory": {"window_peak_bytes": peak_window, "peak_bytes": peak},
            **counts, "traced": traced, "trace": tr,
        }
        print(f"the family's counts {counts!r}; an epoch of the window {epoch_s!r} s",
              file=sys.stderr)
        for m in cell_metrics(spec, workload, "per_layer"):
            value = load_reader(bench_dir, m["name"])(record)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = tr.t0, tr.t1
        breakdown = {"device_ops": tr.top_device_ops(), "idle_gaps": tr.idle_gaps((lo, hi))}
        busy_s, window_s = tr.busy_s(), traced["wall_s"]
        print(f"traced job: {traced['epochs']} epochs in {window_s!r} s, device busy "
              f"{busy_s!r} s, launches {traced['launches']}", file=sys.stderr)
        traced = None

    # the check, once the window has closed and the program's state is freed
    free_program(cell)
    t_ref = time.perf_counter()
    problem = family.reference_problem(cell)
    w0 = family.initial_weights(cell.weights, seed, device)
    ref = family.reference_readings(problem, w0, device, traffic["check_steps"])
    numbers = family.check_numbers(cell, prog, ref)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items() if k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and len(checks) == len(limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if on_card else None}
    if trace:
        device_info.update(busy_s=busy_s, window_s=window_s)
    found = forbidden_modules()
    if found:
        raise RunError(f"modules loaded in the run's process: {found}")
    out = {"correct": bool(correct), "attempted": win["epochs"], "failed": win["nonfinite"],
           "metrics": result_metrics, "device": device_info}
    if trace:
        out["breakdown"] = breakdown
    out["checks"] = checks
    print(f"program losses {prog['losses']!r}; reference losses {ref['losses']!r}; the "
          f"check took {time.perf_counter() - t_ref!r} s", file=sys.stderr)
    return out
