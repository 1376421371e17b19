"""The benchmark of brief_pytorch_tpu_torch on one NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json from the root of a checkout: set-up (the
cell's configuration and traffic from their files, the program's kernels
built into its build/ directory at first use), the measured window, the
comparison of what the window's program produced with the plain reference
(portbench/reference/), and with --trace 1 a short traced sub-window
read by the cell's per-layer metrics (portbench/metrics/<name>.py).  The
last line of standard output is the result, one JSON object; standard
error ends with each number compared beside its limit.  Without a CUDA
card (or with fewer than the cell asks for) it prints no result and exits
with 2.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "brief_pytorch_tpu")


def loaded_forbidden():
    """Top-level module names in sys.modules that the run must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_env(root: str) -> None:
    """Kernel caches at fixed paths inside the checkout, so that only a
    cell's first run there compiles (the program's own CUDA libraries go
    to <root>/build, ops/build.py); one thread for torch's and the math
    libraries' host pools, so that they do not contend with the program's
    own threads for the host's cores.  Set before torch is imported."""
    cache = os.path.join(root, "build", "cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            data_path=None, overrides=None, t_start: float = T_START):
    """Run one cell and return (result dict, earlier lines, the checks)."""
    import torch
    from portbench import counts
    from portbench.harness import manifest
    from portbench.harness.readings import Readings
    from portbench.harness.run_state import Run, SmiSampler

    cell = manifest.cell(name)
    torch.manual_seed(seed % (1 << 63))
    r = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
            device=torch.device(device), t_start=t_start,
            data_path=data_path, overrides=dict(overrides or {}))
    # the traffic's kind names its loop: portbench/loops/<kind>.py
    loop = importlib.import_module("portbench.loops." + cell.traffic["loop"])
    smi = SmiSampler()
    out = loop.run(r, smi)

    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in out.checks.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        out.failed == 0

    if trace:
        rd = Readings(unit=out.unit, units_per_s=out.units_per_s,
                      trace=out.trace, work=out.work, peaks=counts.peaks())
        metrics = {}
        for m in cell.per_layer:
            v = manifest.reader(m["name"])(rd) if out.trace else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        # a cell's own variant of a quantity (train_coords_per_s.single)
        # is the quantity its loop measured (train_coords_per_s)
        metrics = {m["name"]: {"value": float(
            out.end_to_end[m["name"].split(".")[0]]), "unit": m["unit"]}
            for m in cell.end_to_end}
    dev = {"platform": "gpu" if r.device.type == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(r.device)
           if r.device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in out.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in out.trace.idle_gaps]}
    lines = [f"{when}: {text}" for when, text in smi.samples] + out.notes \
        + [f"setup_s {out.end_to_end['setup_s']!r}"]
    if out.trace is not None:
        lines.append(f"traced sub-window: {out.trace.units} {out.unit}s, "
                     f"{out.trace.device_events} device events, "
                     f"{out.trace.launches} launch calls, "
                     f"busy {out.trace.busy_s:.6f} s of "
                     f"{out.trace.window_s:.6f} s, kernel s by range "
                     f"{out.trace.range_kernel_s}")
    result["checks"] = checks
    return result, lines, checks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    run_env(ROOT)

    import torch
    from portbench.harness import manifest
    chips = manifest.cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {a.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines, checks = execute(a.workload, a.seed, a.seconds,
                                    bool(a.trace), "cuda:0")
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
