"""Comms logger (counterpart of ``deepspeed_tpu/utils/comms_logging.py``;
reference ``deepspeed/utils/comms_logging.py``).

Records, per collective kind, the message sizes and counts of every call
made through the ``comm`` facade (``@timed_op``).  The message size is the
bytes of the tensor the caller hands in: the shard for an all-gather, the
whole tensor for a reduce-scatter or an all-reduce.  ``log_all`` prints the
reference's summary table; ``show_bandwidth`` re-times each (op, size) as a
standalone collective over the world (``comm.benchmark.run_op``) for the
algbw/busbw columns.  ``totals`` gives calls and bytes per kind,
``totals_by_axis`` the same per kind and mesh axes (``'model'`` for the
tensor-parallel collectives, ``'data/expert'`` for ZeRO's).
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict

from .logging import logger


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    names = ("B", "KB", "MB", "GB", "TB")
    i = min(int(math.floor(math.log(size_bytes, 1024))), len(names) - 1)
    return f"{round(size_bytes / 1024 ** i, 2)} {names[i]}"


def _get(config, key, default):
    if isinstance(config, dict):
        return config.get(key, default)
    return getattr(config, key, default)


class CommsLogger:
    def __init__(self, config=None):
        self.enabled = bool(_get(config, "enabled", True))
        self.verbose = bool(_get(config, "verbose", False))
        self.prof_all = bool(_get(config, "prof_all", True))
        self.prof_ops = list(_get(config, "prof_ops", []) or [])
        # op name -> msg size -> [count, total_bytes]
        self.comms_dict: Dict[str, Dict[int, list]] = defaultdict(
            lambda: defaultdict(lambda: [0, 0]))
        # (op name, axes) -> [count, total_bytes]
        self.axis_dict: Dict[tuple, list] = defaultdict(lambda: [0, 0])
        # (op name, dtype) -> [count, total_bytes]: the wire format
        self.dtype_dict: Dict[tuple, list] = defaultdict(lambda: [0, 0])

    def _should_log(self, op_name: str) -> bool:
        return self.enabled and (self.prof_all or op_name in self.prof_ops)

    def append(self, op_name: str, msg_size: int, axis: str = None,
               dtype: str = None) -> None:
        if not self._should_log(op_name):
            return
        rec = self.dtype_dict[(op_name, dtype)]
        rec[0] += 1
        rec[1] += msg_size
        rec = self.comms_dict[op_name][msg_size]
        rec[0] += 1
        rec[1] += msg_size
        rec = self.axis_dict[(op_name, axis)]
        rec[0] += 1
        rec[1] += msg_size
        if self.verbose:
            logger.info(f"comm op: {op_name} | msg size: {convert_size(msg_size)}")

    def totals(self) -> Dict[str, Dict[str, int]]:
        """``{op: {"calls": n, "bytes": b}}`` over every recorded size."""
        return {op: {"calls": sum(c for c, _ in sizes.values()),
                     "bytes": sum(b for _, b in sizes.values())}
                for op, sizes in sorted(self.comms_dict.items())}

    def totals_by_axis(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """``{op: {axes: {"calls": n, "bytes": b}}}``."""
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for (op, axis), (count, total) in sorted(self.axis_dict.items(),
                                                 key=lambda kv: (kv[0][0], str(kv[0][1]))):
            out.setdefault(op, {})[str(axis)] = {"calls": count, "bytes": total}
        return out

    def totals_by_dtype(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """``{op: {dtype: {"calls": n, "bytes": b}}}``: the wire formats."""
        out: Dict[str, Dict[str, Dict[str, int]]] = {}
        for (op, dt), (count, total) in sorted(self.dtype_dict.items(),
                                               key=lambda kv: (kv[0][0], str(kv[0][1]))):
            out.setdefault(op, {})[str(dt)] = {"calls": count, "bytes": total}
        return out

    def log_all(self, print_log: bool = True, show_bandwidth: bool = False) -> str:
        header = (f"{'Comm. Op':<25}{'Message Size':<20}{'Count':<10}"
                  f"{'Total Traffic':<20}")
        if show_bandwidth:
            header += f"{'algbw GB/s':<14}{'busbw GB/s':<14}"
        lines = [header]
        for op_name, sizes in sorted(self.comms_dict.items()):
            lines.append(op_name)
            for size, (count, total) in sorted(sizes.items()):
                row = (f"{'':<25}{convert_size(size):<20}{count:<10}"
                       f"{convert_size(total):<20}")
                if show_bandwidth:
                    row += self._bandwidth_cols(op_name, size)
                lines.append(row)
        if print_log:
            logger.info("\n".join(lines))
        return "\n".join(lines)

    def _bandwidth_cols(self, op_name: str, size: int) -> str:
        from ..comm import get_world_size
        from ..comm.benchmark import BUSBW_FACTOR, run_op

        if op_name not in BUSBW_FACTOR or size <= 0:
            return f"{'-':<14}{'-':<14}"
        # the logged message is the op's input; an all-gather's is 1/n of
        # the size the benchmark counts
        if op_name == "all_gather":
            size *= get_world_size()
        enabled, self.enabled = self.enabled, False   # the re-timing is not logged
        try:
            r = run_op(op_name, size, trials=5, warmups=2)
        finally:
            self.enabled = enabled
        return f"{r['algbw_gbps']:<14.2f}{r['busbw_gbps']:<14.2f}"

    def reset(self) -> None:
        self.comms_dict.clear()
        self.axis_dict.clear()
        self.dtype_dict.clear()
