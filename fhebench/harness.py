"""One run of one cell: set-up, a closed-loop window of jobs, the comparison with
the plain reference, and the result line.

Everything a cell is made of is found by name: the configuration
(``configs/<config>.json``), the traffic mix (``traffic/<mix>.json``, whose
``job`` names the program-side body in ``jobs/<job>.py``, its reference in
``reference/<job>.py`` and its operations in ``cost/<job>.py``), the cell's
limits (``limits/<cell>.json``) and each metric's reader
(``end_to_end/<name>.py``, ``metrics/<name>.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from fhebench import check, cost, inputs, tracing

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Window:
    setup_s: float
    start: float
    last_done: float
    latencies: list


def load_json(*parts) -> dict:
    return json.loads(HERE.joinpath(*parts).read_text())


def cell(name: str, bench: dict) -> tuple[dict, dict, dict, dict]:
    """(workload entry, configuration, traffic mix, limits) of the cell ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return (entry, load_json("configs", f"{entry['config']}.json"), load_json("traffic", f"{entry['traffic']}.json"),
            load_json("limits", f"{name}.json"))


def metrics_for(name: str, kind: str, bench: dict) -> list[dict]:
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def reader(folder: str, name: str):
    spec = importlib.util.spec_from_file_location(f"fhebench_{folder}_{name}", HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that the run may not hold, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def least_s_per_job(cfg: dict, mix: dict) -> float:
    ops = importlib.import_module(f"fhebench.cost.{mix['job']}").ops(cfg, mix)
    alpha = -(-(cfg["L"] + 1) // cfg["dnum"])
    return cost.least_seconds(ops, cfg["n"], alpha)


def run_cell(name: str, bench: dict, seed: int, seconds: float, trace: bool, t0: float,
             device="cuda", trace_path: pathlib.Path | None = None, parts=None, job_factory=None) -> dict:
    """One run; returns the result line as a dict (``checks`` last).

    ``parts`` (entry, configuration, mix, limits) and ``job_factory`` replace what
    the name finds: the tests run small configurations and broken jobs on the CPU."""
    import torch

    entry, cfg, mix, limits = parts or cell(name, bench)
    if mix["loop"] != "closed" or mix["clients"] != 1:
        raise NotImplementedError("the harness drives closed loops of one client")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from repro_torch.kernels import cuda

        cuda.build_all()
    ins = inputs.make(cfg, mix, seed)
    make = job_factory or importlib.import_module(f"fhebench.jobs.{mix['job']}").Job
    job = make(cfg, mix, ins, device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    quiet = lambda _name: contextlib.nullcontext()
    for i in range(mix["warmup_jobs"]):
        job.run(job.pool[i % len(job.pool)], quiet)
    sync()
    peak_setup = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    gc.collect()  # no collector pauses inside the window: set-up's objects frozen, the window's collected after it
    gc.freeze()
    gc.disable()
    setup_s = time.perf_counter() - t0

    outputs, latencies = [], []

    def one(i: int, span) -> float:
        k = i % len(job.pool)
        issued = time.perf_counter()
        out = job.run(job.pool[k], span)
        done = time.perf_counter()
        latencies.append(done - issued)
        outputs.append((k, out))
        return done

    i, start = 0, time.perf_counter()
    last = start
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts) as prof:
            start = time.perf_counter()
            with record_function("window"):
                for i in range(mix["trace_jobs"]):
                    with record_function("job"):
                        last = one(i, record_function)
            sync()
        i = mix["trace_jobs"]
        trace_path = trace_path or HERE.parent / "build" / "fhebench" / f"trace.{name}.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
        del prof
    while last - start < seconds:
        last = one(i, quiet)
        i += 1
    peak_window = torch.cuda.max_memory_allocated() if on_card else 0
    gc.enable()
    gc.unfreeze()
    window = Window(setup_s, start, last, latencies)
    lat = np.asarray(latencies) * 1e3
    print(f"window: {len(lat)} jobs in {last - start:.3f} s; latency ms min {lat.min():.2f} median "
          f"{np.median(lat):.2f} max {lat.max():.2f}; first {np.round(lat[:3], 2).tolist()} last "
          f"{np.round(lat[-3:], 2).tolist()}; setup {setup_s:.3f} s", file=sys.stderr)
    del job
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    answers, order = {}, []  # each distinct answer once, by digest, and every job's digest in order
    for k, out in outputs:
        c0, c1 = out.c0.numpy(), out.c1.numpy()
        key = check.digest(c0, c1)
        order.append(key)
        answers.setdefault(key, (k, c0, c1, out.level, out.scale))
    del outputs

    verdict = check.judge(cfg, mix, ins, answers, limits["max_err"])
    correct = verdict["max_err"] <= limits["max_err"] and verdict["meta_mismatch"] <= limits["meta_mismatch"]
    result = dict(correct=bool(correct and latencies), attempted=len(order),
                  failed=sum(1 for k in order if k in verdict["bad"]))
    device_info = dict(platform="gpu" if on_card else "cpu",
                       kind=torch.cuda.get_device_name(0) if on_card else "cpu",
                       count=entry["chips"], memory_peak_bytes=int(max(peak_setup, peak_window)))
    metrics = {}
    if trace:
        tr = tracing.load(trace_path, least_s_per_job(cfg, mix), peak_window or None)
        for m in metrics_for(name, "per_layer", bench):
            v = reader("metrics", m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        device_info.update(busy_s=tracing.busy_s(tr), window_s=tr.window_s)
        result["breakdown"] = tracing.breakdown(tr)
    else:
        for m in metrics_for(name, "end_to_end", bench):
            v = reader("end_to_end", m["name"])(window)
            if v is None:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            metrics[m["name"]] = dict(value=v, unit=m["unit"])
    result["metrics"] = metrics
    result["device"] = device_info
    checks = {"max_err": dict(value=verdict["max_err"], limit=limits["max_err"]),
              "meta_mismatch": dict(value=verdict["meta_mismatch"], limit=limits["meta_mismatch"])}
    ordered = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device", "breakdown") if k in result}
    ordered["checks"] = checks
    found = forbidden_modules()  # last: after the reference, the work count and every reader have loaded
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(found)}")
    return ordered
