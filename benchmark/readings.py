"""Readings that the limits of the compared numbers are set from.

    python benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--out FILE]

For each seed of ``--seeds`` it sets the cell up as a run does and
compares what the timed path produced (a training cell's first steps; a
render cell's requests of a short window) with the float32 reference: the
lower readings. For each of ``--control-seeds`` it compares the reference
computed in fp8 (the control) with the float32 reference: the upper
readings. For each of ``--fault-seeds`` it reads each fault the cell can
have, planted in the reference put in the program's place (``faults.py``):
half the batch, and a zero gradient of the hash tables.
Two witnesses: ``--bf16-seeds`` reads the reference computed in bf16, the
configurations' own precision, against float32; ``--set`` changes the
configuration (e.g. ``train.compute_dtype=float32``). No window is timed.
One JSON line per reading, to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[0] = str(ROOT)


def _session(name: str, seed: int, device, config=None):
    import importlib

    from benchmark import harness

    c = harness.cell(name)
    driver = importlib.import_module(f"benchmark.drivers.{c['traffic_file']['kind']}")
    s = driver.Session(config or c["config_file"]["config"], c["traffic_file"], seed, device)
    return driver, s


def readings(name: str, seed: int, device, what: str, render_seconds: float, config=None,
             detail: bool = False) -> dict:
    import torch

    from benchmark import faults
    from benchmark.reference.precision import BF16, FP8

    driver, s = _session(name, seed, device, config)
    s.warm_up()
    if s.kind == "render":
        s.window(render_seconds, time.perf_counter)
    s.release()
    out = {"workload": name, "seed": seed, "reading": what}
    if s.kind == "train":
        ref = s.reference_readings()
        if what == "program":
            out.update(driver.numbers(s.readings, ref))
            if detail:
                out["detail"] = {"program": s.readings, "reference": ref}
        elif what in ("control", "bf16"):
            got = s.reference_readings(FP8 if what == "control" else BF16)
            out.update(driver.numbers(got, ref))
        else:
            out["half_batch"] = driver.numbers(s.reference_readings(batch_fault=faults.half_batch), ref)
            out["zero_tables"] = driver.numbers(s.reference_readings(grad_fault=faults.zero_tables), ref)
            out["unchanged"] = {"change_gap": 1.0, "table_change_gap": 1.0, "note": "reads 1 by the measure"}
    else:
        ref = s.reference_readings()
        if what == "program":
            out.update(driver.numbers({i: s.outputs[i] for i in ref}, ref))
        elif what in ("control", "bf16"):
            out.update(driver.numbers(s.reference_readings(FP8 if what == "control" else BF16), ref))
        else:
            out["altered"] = driver.numbers({i: faults.swap_rows(v) for i, v in ref.items()}, ref)
            s.poses = {k: faults.half_rows(v, dim=1) for k, v in s.poses.items()}
            out["half_batch"] = driver.numbers(s.reference_readings(), ref)
            first = next(iter(ref.values()))
            out["stale"] = driver.numbers({i: first for i in ref}, ref)
    del s
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--bf16-seeds", type=int, nargs="*", default=[],
                   help="read the reference computed in bf16 against float32: a witness")
    p.add_argument("--render-seconds", type=float, default=5.0)
    p.add_argument("--out")
    p.add_argument("--set", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                   help="change the configuration, for a witness run (e.g. train.compute_dtype=float32)")
    p.add_argument("--detail", action="store_true", help="add each reading's loss terms and leaf norms")
    args = p.parse_args()

    import torch

    from avr_torch.ops import _build

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    _build.build_all()
    device = torch.device("cuda", 0)
    plan = [(s, "program") for s in args.seeds] + [(s, "control") for s in args.control_seeds] + \
        [(s, "faults") for s in args.fault_seeds] + [(s, "bf16") for s in args.bf16_seeds]
    for seed, what in plan:
        t = time.perf_counter()
        config = None
        if args.set:
            import copy

            from benchmark import harness

            config = copy.deepcopy(harness.cell(args.workload)["config_file"]["config"])
            for item in args.set:
                key, value = item.split("=", 1)
                section, name = key.split(".")
                config[section][name] = json.loads(value) if value[:1] in "0123456789-[{" else value
        rec = readings(args.workload, seed, device, what, args.render_seconds, config=config, detail=args.detail)
        rec["seconds"] = time.perf_counter() - t
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
