"""Rehearse ``chip_smoke.py``'s 4-card sequence-parallel gate on the CPU.

``sp4_740m`` and ``uly_7b`` hold the losses of a 'seq' axis of 4 within
``TP_DP_LOSS_RTOL`` of one card's run of the same tokens.  This runs the
same comparison on gloo ranks at a CPU size (the model's widths, fewer
layers, a shorter row, fp32) and prints, per step, how far the losses and
the global gradient norms of 4 ranks lie from one process's.  Run
it on a copy of the repo with a fault planted in the sequence-parallel
code to see whether the gate would notice the fault:

    python tests/sp_gate_rehearsal.py --model llama-740m --layers 2 --seq 512
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests._torch_ranks import run_ranks  # noqa: E402


SP, STEPS, SEED, TIMEOUT_S = 4, 3, 0, 900.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="llama-740m")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    args = ap.parse_args()
    kw = dict(model=args.model, layers=args.layers, seq=args.seq, steps=STEPS, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        one = run_ranks(1, "sp_gate", tmp, timeout=TIMEOUT_S, **kw)[0]
        ranks = run_ranks(SP, "sp_gate", tmp, timeout=TIMEOUT_S, **kw)

    def rel(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]

    out = {**kw, "sp": SP, "one_process": one, "sp_rank0": ranks[0],
           "ranks_equal": all(r == ranks[0] for r in ranks),
           "loss_rel_diff": rel(ranks[0]["losses"], one["losses"]),
           "grad_norm_rel_diff": rel(ranks[0]["grad_norms"], one["grad_norms"])}
    out["loss_max_rel_diff"] = max(out["loss_rel_diff"])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
