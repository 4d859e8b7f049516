"""Offline consolidation of a training checkpoint into fp32 weights
(counterpart of ``deepspeed_tpu/checkpoint/zero_to_fp32.py``; reference
``deepspeed/utils/zero_to_fp32.py``).

Consolidation reads the masters (the compute params when training ran
without masters) from the checkpoint onto the host, with no engine, no
card and no process group: DCP assembles a data-parallel run's shards
(each rank's DTensor chunks) into whole tensors by their global offsets.
They are written as a flat ``{'a/b/c': fp32}`` dict, the names the JAX
package's export uses:

  - ``.npz``: numpy's archive (what the JAX package writes by default);
  - ``.pt``/``.bin``: ``torch.save`` of the same dict of tensors.

Either format loads back into a parameter tree of either package by name:
:func:`load_fp32_state_dict` reads one, :func:`state_dict_to_params` fills
a template tree.

CLI::

    python -m deepspeed_tpu_torch.checkpoint.zero_to_fp32 <ckpt_dir> <out_file> \\
        [--tag TAG] [--format {npz,pt}]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..resilience.integrity import LATEST_FILE, read_latest
from ..runtime.checkpoint_engine.dcp_engine import STATE_DIR, _dcp
from ..utils.logging import logger
from ..utils.tree import tree_map_with_path


def _resolve_tag(checkpoint_dir: str, tag: Optional[str]) -> str:
    tag = tag or read_latest(checkpoint_dir)
    if tag is None:
        raise FileNotFoundError(
            f"no '{LATEST_FILE}' file in {checkpoint_dir} and no tag given")
    if not os.path.isdir(os.path.join(checkpoint_dir, str(tag))):
        raise FileNotFoundError(
            f"checkpoint tag dir not found: {os.path.join(checkpoint_dir, str(tag))}")
    return str(tag)


def read_state(checkpoint_dir: str, tag: Optional[str] = None,
               prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every saved tensor whose key starts with ``prefix``, read onto the
    host at its saved shape and dtype, keyed by its full key."""
    dcp = _dcp()
    path = os.path.join(checkpoint_dir, _resolve_tag(checkpoint_dir, tag), STATE_DIR)
    reader = dcp.FileSystemReader(path)
    meta = reader.read_metadata().state_dict_metadata
    target = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
              for k, m in meta.items() if k.startswith(prefix)}
    dcp.load(target, storage_reader=reader)
    return target


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """``{'a/b/c': fp32 tensor}`` of a saved engine checkpoint: the masters,
    or the params when the run kept none (fp32 compute)."""
    state = read_state(checkpoint_dir, tag, prefix="master_params/")
    prefix = "master_params/"
    if not state:
        state, prefix = read_state(checkpoint_dir, tag, prefix="params/"), "params/"
    return {k[len(prefix):]: v.float() for k, v in state.items()}


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str, tag: Optional[str] = None,
        fmt: Optional[str] = None) -> str:
    """Write the consolidated fp32 weights to ``output_file`` (.npz or .pt)."""
    sd = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    fmt = fmt or ("pt" if output_file.endswith((".pt", ".bin")) else "npz")
    if fmt == "pt":
        torch.save(sd, output_file)
    else:
        np.savez(output_file, **{k: v.numpy() for k, v in sd.items()})
    nbytes = sum(v.numel() * 4 for v in sd.values())
    logger.info(f"wrote {len(sd)} fp32 tensors ({nbytes / 1e9:.2f} GB) "
                f"-> {output_file}")
    return output_file


def load_fp32_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A flat fp32 state dict from a ``.npz`` or ``.pt``/``.bin`` file
    (either package's export)."""
    if path.endswith((".pt", ".bin")):
        return dict(torch.load(path, map_location="cpu", weights_only=True))
    with np.load(path) as z:
        return {k: torch.from_numpy(np.array(z[k])) for k in z.files}


def state_dict_to_params(flat: Dict[str, torch.Tensor], params_template: Any) -> Any:
    """A tree shaped like ``params_template`` holding ``flat``'s tensors,
    each cast to the template leaf's dtype and moved to its device."""
    def fill(path, leaf):
        if path not in flat:
            raise KeyError(f"checkpoint has no tensor for param '{path}' "
                           f"(available: {sorted(flat)[:5]}...)")
        t = torch.as_tensor(flat[path])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for '{path}': checkpoint "
                             f"{tuple(t.shape)} vs template {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return tree_map_with_path(fill, params_template)


def load_state_dict_from_zero_checkpoint(params_template: Any, checkpoint_dir: str,
                                         tag: Optional[str] = None) -> Any:
    """A tree shaped like ``params_template`` filled with the checkpoint's
    fp32 weights (the reference mutates a torch module; here, as in the JAX
    package, the new tree is returned)."""
    return state_dict_to_params(
        get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag), params_template)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Consolidate a deepspeed_tpu_torch checkpoint into fp32 weights")
    ap.add_argument("checkpoint_dir")
    ap.add_argument("output_file")
    ap.add_argument("--tag", default=None)
    ap.add_argument("--format", dest="fmt", choices=["npz", "pt"], default=None)
    args = ap.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(
        args.checkpoint_dir, args.output_file, tag=args.tag, fmt=args.fmt)


if __name__ == "__main__":
    main()
