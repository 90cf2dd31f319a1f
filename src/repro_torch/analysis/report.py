"""Render the dry run's JSON (``launch/dryrun.py``) as tables: one card,
LP on and off, and rank 0 of the single-pod and multi-pod grids, as the
JAX package's ``report.main`` renders its dry runs.

    PYTHONPATH=src python -m repro_torch.analysis.report [--results DIR]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.analysis.roofline import HBM_BYTES
from repro_torch.launch.dryrun import RESULTS

TITLE = "one NVIDIA H100 80GB HBM3 (700 W), tp = 1"
TABLES = (("dryrun_torch", f"{TITLE}, LP (default plan)"),
          ("dryrun_torch_nolp", f"{TITLE}, no LP"),
          ("dryrun_torch_16x16", "Single pod — (data=16, model=16), 256 H100s, "
                                 "rank 0, LP"),
          ("dryrun_torch_mp", "Multi-pod — (pod=2, data=16, model=16), 512 H100s, "
                              "rank 0, LP"))


def load(results: Path, name: str):
    p = results / f"{name}.json"
    return json.loads(p.read_text()) if p.exists() else {}


def roofline_table(d, *, title):
    lines = [f"### {title}", "",
             "| cell | bneck | t_comp (s) | t_mem (s) | t_coll (s) | "
             "coll ops | coll GB | peak GiB (≥) | MF/HF | roofline |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for k in sorted(d):
        v = d[k]
        if "skipped" in v:
            lines.append(f"| {k} | — | — | — | — | — | — | — | — | "
                         f"skip: {v['skipped'][:40]} |")
            continue
        if "error" in v:
            lines.append(f"| {k} | ERROR {v['error'][:60]} | | | | | | | | |")
            continue
        r = v["roofline"]
        m = v["memory"]["peak_gb"]
        lines.append(
            f"| {k} | {r['bottleneck']} | {r['t_compute_s']:.4f} | "
            f"{r['t_memory_s']:.4f} | {r['t_collective_s']:.4f} | "
            f"{int(r.get('coll_ops', 0))} | {r['coll_gbytes']:.3f} | {m:.2f} | "
            f"{r['useful_fraction']:.3f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def summary_stats(d):
    ok = [v for v in d.values() if "roofline" in v]
    sk = [v for v in d.values() if "skipped" in v]
    er = [v for v in d.values() if "error" in v]
    over = [f"{v['arch']}/{v['shape']}" for v in ok if v["memory"]["over_budget"]]
    return (f"{len(ok)} modelled, {len(sk)} documented skips, "
            f"{len(er)} errors; cells over the {HBM_BYTES / 1e9:.0f} GB HBM "
            f"budget (weights, state, batch and cache; no activations): "
            f"{', '.join(over) if over else 'none'}")


def render(results: Path) -> str:
    out = []
    for name, title in TABLES:
        d = load(results, name)
        if not d:
            out.append(f"[{name}: no results yet]\n")
            continue
        out += [roofline_table(d, title=title), "",
                f"**Summary:** {summary_stats(d)}", ""]
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--results", default=str(RESULTS),
                    help="directory holding dryrun_torch*.json")
    print(render(Path(ap.parse_args(argv).results)))


if __name__ == "__main__":
    main()
