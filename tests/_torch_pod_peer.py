"""A simulated pod host (not a test): a plain process that holds no card and
speaks the pod protocol through the coordination store, as a host of the
pod would.  ``chip_smoke.py``'s phase ``pod`` starts it beside the launched
training process; tests start it too.

    python tests/_torch_pod_peer.py SPEC.json

``SPEC``: ``store`` (the coordination store's directory), ``host`` (its
id), ``lease_s``, ``ckpt_dir``, ``out`` (a JSON-lines file of what it did)
and optionally ``hold_tag``.  Every ``lease_s / 3`` it renews its lease at
the store's current generation, and for each commit the coordinator
announces (``commit/gen<g>``) it writes a small shard file and its host
manifest into the tag, except for ``hold_tag``: there it records
``{"event": "hold"}`` and writes nothing, waiting to be killed before its
manifest lands.  It imports the coordination store and the checkpoint
integrity module only, and never initializes CUDA.
"""
from __future__ import annotations

import json
import os
import sys
import time


def _write_shard(tag_dir: str, host: str):
    rel = os.path.join("shards", f"{host}.bin")
    path = os.path.join(tag_dir, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"shard of {host}".encode() * 4)
    return [rel]


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from deepspeed_tpu_torch.elasticity.coordination import (FileCoordinationStore, beat,
                                                             read_generation)
    from deepspeed_tpu_torch.resilience.integrity import write_host_manifest

    with open(sys.argv[1]) as f:
        spec = json.load(f)
    store = FileCoordinationStore(spec["store"])
    host, lease = spec["host"], float(spec["lease_s"])
    out = open(spec["out"], "a")

    def record(**kw):
        out.write(json.dumps({"pid": os.getpid(), "t": time.time(), **kw}) + "\n")
        out.flush()

    record(event="start")
    handled = set()
    while True:
        gen = read_generation(store)
        if gen > 0:
            beat(store, host, gen, lease)
            doc = store.get(f"commit/gen{gen}")
            tag = str(doc["tag"]) if doc else None
            if tag is not None and (gen, tag) not in handled:
                handled.add((gen, tag))
                if tag == spec.get("hold_tag"):
                    record(event="hold", tag=tag, generation=gen)
                else:
                    tag_dir = os.path.join(spec["ckpt_dir"], tag)
                    os.makedirs(tag_dir, exist_ok=True)
                    write_host_manifest(tag_dir, host, gen,
                                        int(tag.replace("global_step", "")),
                                        files=_write_shard(tag_dir, host))
                    record(event="manifest", tag=tag, generation=gen)
        time.sleep(lease / 3.0)


if __name__ == "__main__":
    sys.exit(main())
