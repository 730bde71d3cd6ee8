"""The control of the comparison, and the faults it has to catch: the
numbers ``check.py`` computes when the reference, put in the program's
place, runs in the next precision below float32 (bfloat16), or with a
fault planted in it. The benchmark's own runs never run this; the limits
in ``benchmark/checks/<cell>.json`` are set between what sound runs of
the program read and what this reads.

    python3 -m benchmark.harness.control --workload <cell> --seeds 1 2 3

prints one JSON line a seed with each variant's numbers, as the cell's
traffic kind (``benchmark/kinds/<kind>.py``, its ``control``) reads
them. Progressive cells: ``control`` (the checked frames rendered in
bfloat16), and the faults ``unchanged`` (a frame that leaves the
accumulator as it was), ``half_batch`` (the lower half of the rows left
out) and ``wrong_frame`` (each checked frame's answer is the next
frame's). Training cells, on ``loss_gap`` and ``grad_gap``: ``control``
(the first step in bfloat16) and ``half_batch`` (the loss over the upper
half of the rows); a state left unchanged reads 1 on ``change_gap`` by
construction. Checkpointed
cells: the progressive variants, and on ``saves_off`` a sound reference
save, ``control`` (the accumulator rounded to bfloat16 before the save)
and the faults ``stale`` (the interval before's accumulator under the
new frame), ``wrong_frame`` (the frame index off by one) and ``missing``
(no file). ``--look`` runs the reference against itself over all K
steps instead.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark.harness.inputs import make_inputs
from benchmark.harness.spec import load_cell, load_module


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control's readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--look", action="store_true",
                   help="training: the reference against itself over K steps")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: the control runs on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    kind = load_module("kinds", cell.traffic["kind"])
    for seed in args.seeds:
        inputs = make_inputs(cell, seed, device)
        got = kind.control(inputs, cell, look=args.look)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
