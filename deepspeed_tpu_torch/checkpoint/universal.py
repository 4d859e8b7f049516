"""Checkpoint inspection and compatibility checks (counterpart of
``deepspeed_tpu/checkpoint/universal.py``; reference ``deepspeed/checkpoint/``:
``inspect_checkpoint.py`` and the version gates of
``deepspeed_checkpoint.py``).

The DCP metadata lists every saved tensor with its shape and dtype, so
:func:`inspect_checkpoint` reads no tensor at all.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..resilience.integrity import read_latest
from ..runtime.checkpoint_engine.dcp_engine import CHECKPOINT_VERSION, STATE_DIR, _dcp

__all__ = ["CHECKPOINT_VERSION", "checkpoint_info", "inspect_checkpoint",
           "validate_checkpoint"]


def _tag_dir(checkpoint_dir: str, tag: Optional[str]) -> Tuple[str, str]:
    tag = tag or read_latest(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(f"no 'latest' file in {checkpoint_dir}")
    d = os.path.join(checkpoint_dir, str(tag))
    if not os.path.isdir(d):
        raise FileNotFoundError(f"checkpoint tag dir not found: {d}")
    return str(tag), d


def checkpoint_info(checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint's saved metadata (counters, mesh shape, config,
    format version)."""
    tag, d = _tag_dir(checkpoint_dir, tag)
    info: Dict[str, Any] = {"tag": tag, "path": d}
    meta_path = os.path.join(d, "client_state.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            info.update(json.load(f))
    cfg_path = os.path.join(d, "ds_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            info["ds_config"] = json.load(f)
    return info


def inspect_checkpoint(checkpoint_dir: str, tag: Optional[str] = None
                       ) -> List[Dict[str, Any]]:
    """Per saved tensor ``{name, shape, dtype, bytes}``, from the metadata
    alone."""
    _, d = _tag_dir(checkpoint_dir, tag)
    meta = _dcp().FileSystemReader(os.path.join(d, STATE_DIR)).read_metadata()
    rows = []
    for name, m in sorted(meta.state_dict_metadata.items()):
        dtype = m.properties.dtype
        numel = 1
        for n in m.size:
            numel *= n
        rows.append({"name": name, "shape": tuple(m.size),
                     "dtype": str(dtype).replace("torch.", ""),
                     "bytes": numel * torch.tensor([], dtype=dtype).element_size()})
    return rows


def validate_checkpoint(checkpoint_dir: str, tag: Optional[str] = None,
                        param_count: Optional[int] = None) -> Dict[str, Any]:
    """Fail-fast gate before a restore: the tag and its state exist, the
    format's major version is this build's, and (optionally) the saved
    param count is the caller's.  Returns the info dict; raises ValueError
    on a mismatch."""
    info = checkpoint_info(checkpoint_dir, tag)
    if not os.path.isdir(os.path.join(info["path"], STATE_DIR)):
        raise ValueError(f"checkpoint {info['tag']} has no state dir")
    version = str(info.get("checkpoint_version", CHECKPOINT_VERSION))
    if version.split(".")[0] != CHECKPOINT_VERSION.split(".")[0]:
        raise ValueError(
            f"checkpoint format version {version} is incompatible with this "
            f"build ({CHECKPOINT_VERSION}); re-save with a matching release")
    if param_count is not None and info.get("param_count") not in (None, param_count):
        raise ValueError(
            f"checkpoint was saved from a {info['param_count']:,}-param model "
            f"but the current model has {param_count:,} params")
    return info


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="Inspect a deepspeed_tpu_torch checkpoint")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("--tag", default=None)
    args = ap.parse_args(argv)
    info = checkpoint_info(args.checkpoint_dir, args.tag)
    print(f"tag={info['tag']} step={info.get('global_steps')} "
          f"params={info.get('param_count'):,} mesh={info.get('mesh_shape', {})}")
    total = 0
    for row in inspect_checkpoint(args.checkpoint_dir, args.tag):
        total += row["bytes"]
        print(f"  {row['name']:60s} {str(row['shape']):24s} "
              f"{row['dtype']:10s} {row['bytes'] / 1e6:9.2f} MB")
    print(f"total {total / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
