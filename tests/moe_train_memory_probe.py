"""Peak device memory of ``chip_smoke.py``'s ``moe_train`` phase in one or
more checkouts of the repository: Mixtral-8x7B's widths at
MOE_TRAIN_LAYERS layers through ``initialize`` -> ``train_batch`` (S=4096,
bf16 over fp32 masters), on the capacity path, the no-drop path and the
expert-axis-1 mesh at NCCL world 1.  Not a test (pytest does not collect
it); run it on a card:

    python3 tests/moe_train_memory_probe.py --root parent=.smoke_tree/parent --root change=.

Each ``--root NAME=PATH`` is a checkout (PATH from the current directory);
the parent of a commit is unpacked with ``git archive <commit> | tar -x -C
.smoke_tree/parent``.  Each root runs the phase in a child process of its
own, with its ``chip_smoke.py`` and ``deepspeed_tpu_torch`` first on the
path.  The kernel libraries of the first root are copied into the others
(they are named by their sources' hash, so a copy built from other sources
is not used).  After each run of three steps the child prints one JSON
line: the memory allocated before the steps, the steps' peak, the
allocator's reserved memory, the card's used memory, and the losses and
gradient norms (equal across roots where the arithmetic is).
"""
import argparse
import json
import os
import shutil
import subprocess
import sys

BUILD = os.path.join("deepspeed_tpu_torch", "ops", "csrc", "build")
GIB = 2 ** 30


def child(root: str, seed: int) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    cs.phase_build()
    steps = cs._moe_train_step_record

    def record(engine, batch, per_step, label):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rec = steps(engine, batch, per_step, label)
        stats = torch.cuda.memory_stats()
        free, total = torch.cuda.mem_get_info()
        print(json.dumps({"run": label, "allocated_before_gib": before / GIB,
                          "peak_gib": torch.cuda.max_memory_allocated() / GIB,
                          "reserved_gib": stats["reserved_bytes.all.current"] / GIB,
                          "card_used_gib": (total - free) / GIB,
                          "losses": rec["losses"], "grad_norms": rec["grad_norms"]}),
              flush=True)
        return rec

    cs._moe_train_step_record = record
    cs.phase_moe_train(seed)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.seed)
    if not args.root:
        ap.error("give at least one --root NAME=PATH")
    roots = [r.split("=", 1) for r in args.root]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    rc = 0
    for i, (name, path) in enumerate(roots):
        if i:
            shutil.copytree(os.path.join(roots[0][1], BUILD), os.path.join(path, BUILD),
                            dirs_exist_ok=True)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--seed", str(args.seed), "--child", path],
                             capture_output=True, text=True)
        for line in res.stdout.splitlines():
            if line.startswith('{"run"'):
                print(json.dumps({"root": name, **json.loads(line)}), flush=True)
        if res.returncode:
            rc = res.returncode
            print(f"{name}: exit {res.returncode}\n{res.stderr[-3000:]}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
