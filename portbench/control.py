"""The control of ``correct``: run a cell as ``run.py`` does, then read on
the same sample both the program's gap and the gap of the reference put
in the program's place at the next precision down (fp8 e4m3 products for
a bf16 configuration). Each line's ``correct`` and ``check`` are the
control's verdict by the cell's limit, ``program`` the program's. The
limit of a cell lies above the program's readings and below the
control's. The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds <n>[,<n>...] --seconds <s>

Several seeds run one after the other in one process (the kernels are
built once); each prints one JSON line.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import run as R  # noqa: E402


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, mix = R.load_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        R.log("refused: the control runs on the card")
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        res = R.run_cell(bench, cell, cfg, mix, seed=seed, seconds=args.seconds,
                         trace=False, control=True)
        print(json.dumps({"seed": seed, **res}), flush=True)
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
