"""Times two checkouts of the port against each other on one card: the train
cell's step (llama-740m, S=16384, bf16) and the paged serving tick
(llama2-7b, 8 slots, 128-token pages, the 24-request stream), each with no
monitor, watchdog, SLO rule or sampling attached.  Not a test (pytest does
not collect it); run it on a card:

    python3 tests/hook_cost_probe.py --root parent=.smoke_tree/parent --root change=.

Each ``--root NAME=PATH`` is a checkout of the repository (PATH from the
current directory); the parent of a commit is unpacked with ``git archive
<commit> | tar -x -C .smoke_tree/parent``.  Every measurement runs in a
child process of its own, with the checkout's ``chip_smoke.py`` and
``deepspeed_tpu_torch`` first on its path (the kernels built into that
checkout), in the order given and then reversed, ``--turns`` times (A B B A
for two roots and one turn), so that the roots share the card, its clocks
and its power limit.  Each child prints one JSON line; the parent prints
the card's ``nvidia-smi`` name and power limit, then a summary line of the
medians per root.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

TRAIN_WARM, TRAIN_TIMED = 2, 5


def child(root: str, seed: int) -> int:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM

    cs.phase_build()
    out = {"root": root}
    S = cs.TRAIN_SHAPE[1]
    model, engine = cs._train_engine(seed, S)
    batch = cs._train_batch(model.config, S, seed + 1)
    cs._steps(engine, batch, TRAIN_WARM)
    _, secs, _ = cs._steps(engine, batch, TRAIN_TIMED)
    out["train_step_s"] = secs
    out["train_median_step_s"] = statistics.median(secs)
    del engine, model, batch
    cs.free_memory()
    model = CausalLM("llama2-7b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = model.init_fn(gen, device="cuda", dtype=torch.bfloat16)
    engine = deepspeed_tpu_torch.init_inference(model, config={"dtype": "bf16"},
                                                params=params)
    stream = cs.serving_stream(seed, model.config.vocab_size)
    sv, _, rec = cs._serve_once(engine, stream, "probe")
    out.update({k: rec[k] for k in ("mean_decode_tick_ms", "median_decode_tick_ms",
                                    "decode_ticks", "run_s", "output_tok_per_s")})
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[], metavar="NAME=PATH")
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.seed)
    roots = [r.split("=", 1) for r in args.root]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    order = []
    for _ in range(args.turns):
        order += roots + roots[::-1]
    results = {name: [] for name, _ in roots}
    for name, path in order:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", path,
                            "--seed", str(args.seed)], capture_output=True, text=True)
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith('{"root"')]
        if p.returncode or not lines:
            print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
            return 1
        rec = json.loads(lines[-1])
        rec.update(name=name, child_s=time.perf_counter() - t0)
        print(json.dumps(rec), flush=True)
        results[name].append(rec)
    print(json.dumps({"summary": {name: {
        "train_median_step_s": [r["train_median_step_s"] for r in recs],
        "median_decode_tick_ms": [r["median_decode_tick_ms"] for r in recs],
        "mean_decode_tick_ms": [r["mean_decode_tick_ms"] for r in recs]}
        for name, recs in results.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
