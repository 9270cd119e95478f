"""The port's dry-run against the reference's, cell by cell: per-rank FLOPs
and collective bytes on both production meshes, from the records each
package's dry-run writes.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \\
        --torch-device cpu
    # the reference writes experiments/dryrun/ beside its src/: run it
    # from a copy of the repo (git archive HEAD src | tar -x -C <copy>)
    (cd <copy> && PYTHONPATH=src python -m repro.launch.dryrun --all \\
        --both-meshes)
    python scripts/torch/dryrun_vs_reference.py \\
        --reference <copy>/experiments/dryrun [--baseline <dir>]

Prints one markdown row a cell: for each mesh the port's argument and temp
GiB a rank, its C / M / X ms, its useful-FLOPs ratio, its FLOPs a rank
over the reference's ``hlo_flops_per_device``, and its collective bytes a
rank over the reference's ``collective_bytes_per_device`` (each package's
all-reduce counted twice, a ring's traffic). ``--baseline`` names
an earlier run of the port's dry-run; each mesh then also shows the new
run's FLOPs and collective bytes a rank over the baseline's. Reads JSON
only; imports neither package.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys

PORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..",
                        "experiments", "dryrun_torch")
MESHES = ("16x16", "2x16x16")


def _records(directory: str) -> dict:
    """{(arch, shape, mesh): record} of a dry-run's directory."""
    out = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


def compare(port_dir: str, reference_dir: str,
            baseline_dir: str | None = None) -> list:
    """One dict a (arch, shape) of the port's records: per mesh the port's
    and the reference's FLOPs a rank and collective bytes a rank, their
    ratios (None where the reference has no record), both packages'
    collective bytes by kind, the port's argument and temp GiB, C / M / X
    seconds and useful-FLOPs ratio, and with a baseline the new run's
    FLOPs and collective bytes a rank over the baseline's."""
    port, ref = _records(port_dir), _records(reference_dir)
    base = _records(baseline_dir) if baseline_dir else {}
    rows = {}
    for (arch, shape, mesh), rec in sorted(port.items()):
        rep = rec["roofline"]
        flops = rep["hlo_flops_per_device"]
        r = ref.get((arch, shape, mesh))
        r_rep = r["roofline"] if r else {}
        r_flops = r_rep.get("hlo_flops_per_device")
        coll = rep["collective_bytes_per_device"]
        r_coll = r_rep.get("collective_bytes_per_device")
        mem = rec["memory"]
        cell = {"flops": flops, "reference_flops": r_flops,
                "over_reference": flops / r_flops if r_flops else None,
                "coll": coll, "reference_coll": r_coll,
                "coll_over_reference": coll / r_coll if r_coll else None,
                "breakdown": {"port": rep.get("collective_breakdown"),
                              "reference": r_rep.get(
                                  "collective_breakdown")},
                "gib": [mem["argument_size_in_bytes"] / 2**30,
                        mem["temp_size_in_bytes"] / 2**30],
                "t_s": [rep["t_compute_s"], rep["t_memory_s"],
                        rep["t_collective_s"]],
                "useful": rep.get("useful_flops_ratio")}
        b = base.get((arch, shape, mesh))
        if b:
            b_rep = b["roofline"]
            cell["flops_over_baseline"] = (
                flops / b_rep["hlo_flops_per_device"]
                if b_rep["hlo_flops_per_device"] else None)
            cell["collectives_over_baseline"] = (
                rep["collective_bytes_per_device"]
                / b_rep["collective_bytes_per_device"]
                if b_rep["collective_bytes_per_device"] else None)
        rows.setdefault((arch, shape), {"arch": arch, "shape": shape})[
            mesh] = cell
    return list(rows.values())


def _fmt(x, spec: str) -> str:
    return "-" if x is None else format(x, spec)


def table(rows: list) -> str:
    """``compare``'s rows as a markdown table."""
    baseline = any("flops_over_baseline" in c for row in rows
                   for c in row.values() if isinstance(c, dict))
    head = ["cell"]
    for mesh in MESHES:
        head += [f"{mesh}: args / temp GiB", "C / M / X ms", "useful",
                 "port / ref FLOPs", "port / ref coll."] + (
                     ["FLOPs, coll. / base"] if baseline else [])
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for row in rows:
        cols = [f"{row['arch']} x {row['shape']}"]
        for mesh in MESHES:
            c = row.get(mesh)
            if c is None:
                cols += ["-"] * (6 if baseline else 5)
                continue
            cols += [" / ".join(f"{g:.2f}" for g in c["gib"]),
                     " / ".join(f"{t * 1e3:.1f}" for t in c["t_s"]),
                     _fmt(c["useful"], ".3f"),
                     _fmt(c["over_reference"], ".3f"),
                     _fmt(c["coll_over_reference"], ".3f")]
            if baseline:
                cols.append(", ".join(_fmt(c.get(k), ".3f") for k in (
                    "flops_over_baseline", "collectives_over_baseline")))
        lines.append("| " + " | ".join(cols) + " |")
    return "\n".join(lines)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--port", default=PORT_DIR,
                    help="the port's dry-run records (default "
                         "experiments/dryrun_torch)")
    ap.add_argument("--reference", required=True,
                    help="the reference's dry-run records")
    ap.add_argument("--baseline",
                    help="an earlier run of the port's dry-run")
    args = ap.parse_args(argv)
    rows = compare(args.port, args.reference, args.baseline)
    print(table(rows))
    return rows


if __name__ == "__main__":
    main()
    sys.exit(0)
