"""NUMA discovery + core binding for the host-stepped offload paths
(counterpart of ``deepspeed_tpu/utils/numa.py``; reference
``deepspeed/utils/numa.py`` + ``launcher/launch.py`` core binding).

The ZeRO-Offload/Infinity hot path is on the host: the SIMD CPU Adam
sweeps every master shard and the aio thread pool streams the NVMe files.
Binding those threads to the NUMA node that owns their buffers removes
cross-node memory traffic.  The reference binds each rank at launch
(numactl); here each process binds itself when its offload engine starts
(the OpenMP team and the aio threads inherit the mask).

Pure stdlib: the topology from sysfs (``/sys/devices/system/node``), the
binding through ``os.sched_setaffinity``.  Everything is a no-op where the
kernel or the container hides the topology.  ``DS_TPU_NUMA_NODE`` names a
node, or ``off``.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional

from .logging import log_dist


def _parse_cpu_list(text: str) -> List[int]:
    """'0-3,8-11' -> [0,1,2,3,8,9,10,11]."""
    out: List[int] = []
    for piece in text.strip().split(","):
        piece = piece.strip()
        if not piece:
            continue
        if "-" in piece:
            lo, hi = piece.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(piece))
    return out


def get_numa_nodes() -> Dict[int, List[int]]:
    """{node_id: [cpu, ...]} from sysfs; {} when the topology is hidden."""
    nodes: Dict[int, List[int]] = {}
    for path in sorted(glob.glob("/sys/devices/system/node/node[0-9]*")):
        m = re.search(r"node(\d+)$", path)
        if not m:
            continue
        cpulist = os.path.join(path, "cpulist")
        try:
            with open(cpulist) as f:
                cpus = _parse_cpu_list(f.read())
        except OSError:
            continue
        if cpus:
            nodes[int(m.group(1))] = cpus
    return nodes


def current_affinity() -> List[int]:
    try:
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return []


def bind_to_node(node: Optional[int] = None) -> List[int]:
    """Pin this process (and its future threads — the aio pool and the
    OpenMP CPU-Adam team inherit the affinity mask) to one NUMA node.

    ``node=None`` picks the node owning the most currently-allowed CPUs.
    Returns the CPUs bound to; [] = topology hidden or binding rejected
    (no-op, logged).
    """
    nodes = get_numa_nodes()
    if len(nodes) <= 1:
        log_dist("numa: single-node or hidden topology — no binding",
                 ranks=[0])
        return []
    allowed = set(current_affinity())
    if node is None:
        node = max(nodes, key=lambda n: len(allowed & set(nodes[n])))
    cpus = [c for c in nodes.get(node, []) if not allowed or c in allowed]
    if not cpus:
        log_dist(f"numa: node {node} has no allowed CPUs — no binding",
                 ranks=[0])
        return []
    try:
        os.sched_setaffinity(0, cpus)
    except OSError as e:
        log_dist(f"numa: sched_setaffinity rejected ({e}) — no binding",
                 ranks=[0])
        return []
    log_dist(f"numa: bound to node {node} ({len(cpus)} CPUs)", ranks=[0])
    return cpus


def bind_for_offload(enabled: bool = True) -> List[int]:
    """Entry point the offload engines call: honor DS_TPU_NUMA_NODE
    (explicit node id, or 'off'), else auto-pick."""
    env = os.environ.get("DS_TPU_NUMA_NODE", "").strip().lower()
    if not enabled or env == "off":
        return []
    node = int(env) if env.isdigit() else None
    return bind_to_node(node)
