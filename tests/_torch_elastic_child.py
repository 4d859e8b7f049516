"""A training script of the launcher tests (not a test): the launcher starts
it as ``--module tests._torch_elastic_child SPEC.json``, one process a rank,
on the CPU over gloo, and it reads the rank contract from the environment.

``SPEC["mode"]``:

- ``"env"``: ``comm.init_distributed()`` from the launcher's variables, one
  all-reduce of ``rank + 1``, and the rank's view written to
  ``<out>/env<rank>.json``;
- ``"train"``: ``CausalLM("tiny")`` (fp32) under ``SPEC["config"]`` through
  ``ElasticAgent.run`` for ``SPEC["steps"]`` steps on ``make_batches``
  (``SPEC["ignore"]``: rows with unequal counts of labelled tokens),
  checkpointing into ``SPEC["ckpt_dir"]``.  Each step appends ``{"pid",
  "world", "rank", "step", "loss"}`` to ``<out>/rank<rank>.jsonl``.  A
  ``SPEC["signals"]`` entry ``{"rank", "after_step", "marker"}`` makes that
  rank send itself SIGTERM once, after that step (the marker file records
  that it did).  ``SPEC["pause"]`` ``{"after_step", "ready"}`` makes every
  rank, after that step, touch the ``ready`` file and wait until a signal
  latches a stop; ``SPEC["save_delay_s"]`` makes every save start that
  much later.  The rank exits with ``ElasticAgent.exit_code``; after the
  last step rank 0 saves the fp32 masters by path to ``<out>/final.pt``;
- ``"kernels"`` (on a card): ``CausalLM("tiny", **SPEC["model"])`` in bf16
  under ``SPEC["config"]``, one ``train_batch``, and the K1/K2/K3 launches
  with each kernel library's path, whether it loaded and the seconds this
  process spent building it, to ``<out>/kernels<rank>.json``.
"""
from __future__ import annotations

import json
import os
import signal
import sys
import time
from pathlib import Path

import torch


def _train(spec: dict, rank: int, out: Path) -> int:
    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.elasticity import ElasticAgent
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.utils.tree import tree_flatten_with_path

    from tests._torch_ranks import make_batches

    engine, *_ = ds.initialize(model=CausalLM("tiny", dtype=torch.float32),
                               config=spec["config"], device="cpu")
    batches = make_batches(spec["steps"], engine.train_batch_size, seed=spec["data_seed"],
                           ignore=spec.get("ignore", True))
    delay = spec.get("save_delay_s", 0)
    if delay:
        save = engine.save_checkpoint

        def slow_save(*args, **kwargs):
            time.sleep(delay)
            return save(*args, **kwargs)
        engine.save_checkpoint = slow_save
    agent = ElasticAgent(engine, spec["ckpt_dir"])
    log = open(out / f"rank{rank}.jsonl", "a")

    def step_fn(engine, step):
        loss = float(engine.train_batch(batch=batches[step]))
        log.write(json.dumps({"pid": os.getpid(), "world": engine.dp_world, "rank": rank,
                              "step": step + 1, "loss": loss,
                              "gas": engine.gas, "micro": engine.micro_batch_size}) + "\n")
        log.flush()
        for sig in spec.get("signals", []):
            if (sig["rank"] == rank and sig["after_step"] == step + 1
                    and not os.path.exists(sig["marker"])):
                Path(sig["marker"]).touch()
                os.kill(os.getpid(), signal.SIGTERM)
        pause = spec.get("pause")
        if pause and pause["after_step"] == step + 1:
            Path(pause["ready"]).touch()
            deadline = time.monotonic() + 120
            while not agent.guard.should_stop and time.monotonic() < deadline:
                time.sleep(0.02)

    last = agent.run(step_fn, spec["steps"])
    log.write(json.dumps({"pid": os.getpid(), "rank": rank, "event": "exit", "last": last,
                          "resumed_step": agent.resumed_step,
                          "resumed_tag": agent.resumed_tag}) + "\n")
    log.close()
    if last == spec["steps"]:
        masters = engine.full_params(fp32=True)   # collective
        if rank == 0:
            torch.save({p: x.detach().clone() for p, x in tree_flatten_with_path(masters)},
                       out / "final.pt")
    agent.guard.uninstall()
    return agent.exit_code(last, spec["steps"])


def _kernels(spec: dict, rank: int, out: Path) -> int:
    import numpy as np

    import deepspeed_tpu_torch as ds
    from deepspeed_tpu_torch.models import CausalLM
    from deepspeed_tpu_torch.ops.kernels import flash_attention as fa

    model = CausalLM("tiny", dtype=torch.bfloat16, **spec["model"])
    engine, *_ = ds.initialize(model=model, config=spec["config"])
    rs = np.random.RandomState(0)
    batch = {"input_ids": rs.randint(0, model.config.vocab_size,
                                     (engine.train_batch_size, model.config.max_seq_len))}
    loss = float(engine.train_batch(batch=batch))
    (out / f"kernels{rank}.json").write_text(json.dumps({
        "loss": loss, "gas": engine.gas,
        "launches": [fa.flash_attention.launches, fa.flash_attention_bwd_dq.launches,
                     fa.flash_attention_bwd_dkv.launches],
        "libraries": {b.name: {"path": str(b.library_path()), "loaded": b._lib is not None,
                               "built_here_s": b.build_seconds} for b in fa.builders()}}))
    return 0


def main() -> int:
    spec = json.loads(Path(sys.argv[1]).read_text())
    out = Path(spec["out"])
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    from deepspeed_tpu_torch import comm

    comm.init_distributed(verbose=False)
    if spec["mode"] == "env":
        import torch.distributed as dist

        x = torch.tensor([rank + 1.0])
        dist.all_reduce(x)
        keys = ("RANK", "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT", "DS_ACCELERATOR", "CUDA_VISIBLE_DEVICES", "NODE_RANK")
        (out / f"env{rank}.json").write_text(json.dumps({
            "env": {k: os.environ.get(k) for k in keys},
            "backend": str(dist.get_backend()), "world": dist.get_world_size(),
            "sum": float(x.item())}))
        rc = 0
    elif spec["mode"] == "kernels":
        rc = _kernels(spec, rank, out)
    else:
        rc = _train(spec, rank, out)
    assert "jax" not in sys.modules, "the launched child imported jax"
    comm.destroy_process_group()
    return rc


if __name__ == "__main__":
    sys.exit(main())
