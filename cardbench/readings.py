"""The readings that a cell's limits are set from, on the card at the
cell's own size.

    python3 cardbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out build/readings.jsonl]

For each seed, in one process: the run's problems, then as many calls as
a run judges (``check_calls``), from the call seeds a run draws, through
the program; the reference's answers to the same calls; and the
control's, the reference with its coupling products in TF32 (and, for
the engine, the program's own bfloat16 path as a second look). Prints
one JSON line a seed with each side's numbers against the reference
(``harness.check.compare``) and the reference's seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import run
    run._caches()
    import torch
    from cardbench.harness import check, problems as gen, spec
    from cardbench.reference.answers import answers as reference
    from repro_torch.api import Problem, ProblemSuite, solve_suite

    cell = spec.cell(args.workload)
    cfg, traffic = cell.config, cell.traffic
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        mats = gen.make_problems(cfg, traffic, seed)
        suite = ProblemSuite([Problem.from_couplings(J) for J in mats])
        cs = gen.CallSeeds(seed)
        seeds = [cs.next() for _ in range(int(traffic["check_calls"]))]

        def program(**over):
            opts = dict(traffic["solver_opts"], **over)
            return [check.program_answers(solve_suite(
                suite, solver=traffic["solver"], runs=int(traffic["runs"]),
                seed=s, oracle=False, torch_device=args.device, **opts))
                for s in seeds]

        got = program()
        t0 = time.perf_counter()
        want = reference(cfg, traffic, mats, seeds, args.device)
        row = {"cell": cell.name, "seed": seed,
               "reference_s": time.perf_counter() - t0,
               "program": check.compare(got, want, mats)}
        if seed in controls:
            row["control_tf32"] = check.compare(
                reference(cfg, traffic, mats, seeds, args.device, tf32=True),
                want, mats)
            if traffic["solver"] == "engine":
                from repro_torch.core import DeviceModel, IsingMachine
                m = IsingMachine(device=DeviceModel(
                    compute_dtype="bfloat16"), torch_device=args.device)
                row["program_bf16"] = check.compare(program(machine=m),
                                                    want, mats)
        if args.device != "cpu":
            row["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows)
                                  + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
