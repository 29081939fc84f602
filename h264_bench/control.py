"""The control of a cell's comparison: readings of the program and of the
plain reference with one guarantee broken, put in the program's place.

    python3 h264_bench/control.py --workload <cell> --seeds 7,8,9

For each seed, in one process: the cell's set-up and one GOP of its window
through the program, compared as a run compares it (the program's
reading); then the control's outputs in the program's place and compared
the same way (the control's reading). The control is the reference whose
deblocking filters every vertical edge of the picture and then every
horizontal one (reference/deblock.py:deblock_two_pass), the shortcut that
would tempt a faster filter: the configuration guarantees spec 8.7's
macroblock order. It encodes the IDR's picture and the head of the P frames
from the pictures, and call B's P frames from the program's planes after
call A, where the reference starts too. One JSON line a seed.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_gops(ctrl, plan, gops: list, idr, ring) -> list:
    """The control's records of the GOPs, shaped as the program's: its
    IDRs, its head and call B access units in the first GOP's, its planes
    after the IDR and after call B in every GOP whose planes were kept."""
    au_of, rec0 = ctrl.idr(*idr)
    aus, rec = list(gops[0]["aus"]), rec0
    for p in plan.head:
        aus[p], rec = ctrl.p(*ring[plan.ring_index(p)], rec, p)
    out = []
    for g in gops:
        g = {**g, "idr": au_of(g["idr_pic_id"])}
        if "mid_recon" in g:
            rec = g["mid_recon"]
            for p in plan.tail:
                a, rec = ctrl.p(*ring[plan.ring_index(p)], rec, p)
                if len(out) == 0:
                    aus[p] = a
            g.update(idr_recon=rec0, end_recon=rec)
        out.append(g)
    out[0]["aus"] = aus
    return out


def readings(spec: dict, cell_name: str, seeds: list, device="cuda",
             bench=None):
    """Yield one mapping of readings a seed."""
    import torch

    from h264_bench import harness
    from h264_bench.reference import deblock

    cell = harness.Cell(spec, cell_name, device,
                        bench or harness.HERE)
    for seed in seeds:
        t0 = time.perf_counter()
        cell.stage(seed)
        kept, _, _ = cell.window(0.0)
        cell.release()
        ref = cell.reference()
        args = dict(idr=cell.host[0], ring=cell.ring, seed=seed)
        out = {"workload": cell_name, "seed": seed,
               "program": harness.compare_with(ref, cell.plan, kept, **args)}
        ctrl = cell.reference(deblock=deblock.deblock_two_pass)
        swapped = control_gops(ctrl, cell.plan, kept, cell.host[0],
                               cell.ring)
        out["control"] = harness.compare_with(ref, cell.plan, swapped, **args)
        out["seconds"] = time.perf_counter() - t0
        del kept
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)

    import torch

    from h264_bench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_spec()
    seeds = [int(s) for s in args.seeds.split(",")]
    for out in readings(spec, args.workload, seeds, device="cuda:0"):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
