"""``ds_elastic`` (reference bin/ds_elastic): a config's elastic plan — the
chosen batch size and the compatible device counts, and at ``-w N`` the
micro-batch and gradient accumulation at that data-parallel world.

    python -m deepspeed_tpu_torch.elasticity -c ds_config.json [-w N]
"""
import argparse
import json
import sys

from ..runtime.config import ElasticityConfig
from ..runtime.config_utils import config_from_dict
from .elasticity import ElasticityError, compute_elastic_config


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="ds_elastic",
        description="Show the elastic batch plan for a deepspeed_tpu config")
    ap.add_argument("-c", "--config", required=True,
                    help="path to the deepspeed_tpu JSON config")

    def positive(v):
        n = int(v)
        if n < 0:
            raise argparse.ArgumentTypeError("world size must be >= 0")
        return n

    ap.add_argument("-w", "--world-size", type=positive, default=0,
                    help="bind the plan to this data-parallel world size")
    args = ap.parse_args(argv)

    try:
        with open(args.config) as f:
            cfg = json.load(f)
        ec = config_from_dict(ElasticityConfig, cfg.get("elasticity", {}))
        if not ec.enabled:
            print("elasticity is not enabled in this config")
            return 1
        plan = compute_elastic_config(
            ec, dp_world_size=args.world_size,
            node_size=ec.num_gpus_per_node,
            model_parallel_size=ec.model_parallel_size)
    except (OSError, json.JSONDecodeError, ValueError, TypeError,
            ElasticityError) as e:
        # user errors (bad path or JSON, an incompatible world size, a
        # malformed block) get a message, not a traceback
        print(f"error: {e}")
        return 1
    print(f"train_batch_size      : {plan.train_batch_size}")
    print(f"valid device counts   : {list(plan.valid_device_counts)}")
    if args.world_size > 0:
        print(f"micro batch @ dp={args.world_size:<5}: "
              f"{plan.micro_batch_per_device}")
        print(f"grad accumulation     : {plan.gradient_accumulation_steps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
