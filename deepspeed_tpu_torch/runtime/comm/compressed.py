"""Error-feedback 1-bit compressed gradient exchange (counterpart of
``deepspeed_tpu/runtime/comm/compressed.py``; reference
``deepspeed/runtime/comm/nccl.py:54`` ``compressed_allreduce``, used by the
1-bit optimizers, ``runtime/fp16/onebit/adam.py:308``).

Each rank compresses its own gradient and the ranks exchange the codes:

  1. corrected = local_grad + error           (error feedback)
  2. per-block scale = mean(|corrected|)      (fp32, one per ``block`` elements)
  3. signs packed 8 a byte                    (uint8 on the wire)
  4. all-gather of the packed signs and of the scales over the data axes
  5. every rank decodes every message and averages them
  6. error = corrected - decode(own message)  (what compression lost)

Wire bytes per element: 1/8 (signs) + 4/block (scales), about 0.14 B at
block=256 against 4 B of fp32.  The JAX package's arithmetic, op for op
(the mean over the ranks sums the decoded messages in rank order and
divides once).  As there, the optimizer's moments take the compressed
mean of the gradient (the reference compresses the momentum), and before
``freeze_step`` the full-precision mean runs instead.
"""
from __future__ import annotations

import math
from typing import Any, List, Tuple

import torch

from ... import comm
from ...parallel.mesh import BATCH_AXES

DEFAULT_BLOCK = 256
_BITS = (1, 2, 4, 8, 16, 32, 64, 128)


def _bits(device) -> torch.Tensor:
    return torch.tensor(_BITS, dtype=torch.uint8, device=device)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """bool [n] (n % 8 == 0) -> uint8 [n/8], bit i = element 8k+i."""
    b = signs.reshape(-1, 8).to(torch.uint8)
    return (b * _bits(signs.device)).sum(dim=1, dtype=torch.uint8)


def unpack_signs(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [m] -> fp32 [m*8] of +-1."""
    bits = (packed[:, None] & _bits(packed.device)) > 0
    return torch.where(bits, 1.0, -1.0).to(torch.float32).reshape(-1)


def pad_len(n: int, block: int = DEFAULT_BLOCK) -> int:
    """``n`` rounded up to a multiple of lcm(block, 8)."""
    lcm = math.lcm(block, 8)
    return -(-n // lcm) * lcm


def ef_compress(flat: torch.Tensor, error: torch.Tensor,
                block: int = DEFAULT_BLOCK):
    """flat fp32 [npad] + error [npad] -> (packed uint8, scales fp32,
    new_error).  The scale is the block's mean magnitude of the corrected
    tensor, so sign * scale is the 1-bit code of least L1 error per block
    (the reference's convention, nccl.py:91)."""
    corrected = flat + error
    nb = corrected.shape[0] // block
    blocks = corrected.reshape(nb, block)
    scales = blocks.abs().mean(dim=1)
    signs = corrected >= 0
    packed = pack_signs(signs)
    decoded = (torch.where(signs.reshape(nb, block), 1.0, -1.0)
               * scales[:, None]).reshape(-1)
    return packed, scales, corrected - decoded


def ef_decode(packed: torch.Tensor, scales: torch.Tensor, block: int) -> torch.Tensor:
    signs = unpack_signs(packed)
    return (signs.reshape(-1, block) * scales[:, None]).reshape(-1)


def compressed_mean(flat: torch.Tensor, error: torch.Tensor, axis=BATCH_AXES,
                    block: int = DEFAULT_BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The EF-compressed mean of every rank's ``flat`` over ``axis``:
    (the approximate mean, this rank's new error)."""
    packed, scales, new_error = ef_compress(flat, error, block)
    n = comm.get_axis_size(axis)
    all_packed = comm.all_gather(packed, axis).reshape(n, -1)   # uint8 on the wire
    all_scales = comm.all_gather(scales, axis).reshape(n, -1)
    decoded = torch.stack([ef_decode(all_packed[i], all_scales[i], block)
                           for i in range(n)])
    return decoded.mean(dim=0), new_error


def init_error_tree(params: Any, device=None,
                    block: int = DEFAULT_BLOCK) -> List[torch.Tensor]:
    """This rank's error buffers: one flat fp32 [npad] per parameter leaf
    of ``params`` (whole leaves; meta tensors do), on ``device`` (the
    JAX package's [w * npad] leaf, sharded over the data axes, is every
    rank's buffer side by side)."""
    from ...utils.tree import tree_leaves

    return [torch.zeros(pad_len(x.numel(), block), dtype=torch.float32,
                        device=device if device is not None else x.device)
            for x in tree_leaves(params)]


def flat_padded(g: torch.Tensor, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """``g`` raveled in fp32 and zero-padded to :func:`pad_len`."""
    f = g.reshape(-1).to(torch.float32)
    pad = pad_len(f.numel(), block) - f.numel()
    return torch.nn.functional.pad(f, (0, pad)) if pad else f


def compressed_grads(local: List[torch.Tensor], errors: List[torch.Tensor],
                     inv: float, axis=BATCH_AXES, block: int = DEFAULT_BLOCK):
    """The 1-bit exchange of a window's gradients: each leaf unscaled by
    ``inv`` (the error buffers carry unscaled residuals, so a change of
    the loss scale never re-weights them), compressed, averaged over the
    ranks and scaled back.  Returns (the means at the gradients' scale,
    the new errors)."""
    out, new_errors = [], []
    for g, e in zip(local, errors):
        m, e2 = compressed_mean(flat_padded(g, block) * inv, e, axis, block)
        out.append((m[:g.numel()] / inv).reshape(g.shape))
        new_errors.append(e2)
    return out, new_errors
