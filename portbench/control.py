"""Read a control's numbers on the card: the plain reference put in the
port's place and computed the way a sound check must refuse (the
``CONTROLS`` of ``reference/<reference>_control.py``, ``<reference>`` the
cell's), driven by the cell's own traffic at its own load through the
harness's own run, and judged by the same comparison as a run of the cell.

    python3 portbench/control.py --workload <cell> --control <name> \\
        --seeds <n> [<n> ...] --seconds <s>

Prints one JSON line a seed: the numbers, the cell's limits and whether
the check refused them (``refused``: the run's ``correct`` is false). The
benchmark's own runs never run a control.
"""

import argparse
import json
import os
import sys
import time


def read(bench, name, control, seed, seconds, device, spec=None) -> dict:
    """One control's numbers on cell ``name`` at ``seed``."""
    from portbench import harness
    spec = spec or harness.resolve(bench, name)
    controls = harness.load_module(
        "reference", spec["mix"]["reference"] + "_control").CONTROLS
    out = harness.run_cell(bench, name, seed, seconds, False, device,
                           time.perf_counter(), spec=spec,
                           stand_in=controls[control])
    return {"workload": name, "control": control, "seed": seed,
            "batches": out["batches"],
            "served_s": out["end_to_end"]["window_s"],
            "numbers": out["numbers"], "checks": out["checks"],
            "refused": not out["correct"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, root)
    import torch

    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    bench = harness.load_json(os.path.join(root, "BENCHMARK.json"))
    for seed in args.seeds:
        print(json.dumps(read(bench, args.workload, args.control, seed,
                              args.seconds, torch.device("cuda", 0))),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
