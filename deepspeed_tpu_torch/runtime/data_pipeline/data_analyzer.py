"""Offline dataset analysis for curriculum learning (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_analyzer.py``, whose files it
reads and writes; reference
``runtime/data_pipeline/data_sampling/data_analyzer.py`` ``DataAnalyzer``).

Map-reduce over a dataset: workers each scan a stride-shard computing a
per-sample difficulty metric and persist partial index files; the reduce
merges them into the arrays the curriculum machinery consumes —

  - ``metric_values.npy``  : float/int metric aligned to sample index —
                             exactly the ``sizes`` input of
                             :class:`..data_sampler.CurriculumBatchSampler`
                             (which derives the difficulty ordering itself).

The reference parallelizes via launcher-spawned ranks; here ``run()`` uses
a thread pool (metric fns are usually tokenizer/IO bound and release the
GIL) and the map/reduce halves stay separately callable so a multi-host
launcher can still fan the map out by (worker_id, num_workers).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

DEFAULT_METRIC = "seqlen"


def _seqlen_metric(sample) -> float:
    """Default difficulty: document length (reference curriculum seqlen)."""
    if isinstance(sample, dict):
        sample = sample.get("input_ids", next(iter(sample.values())))
    return float(len(sample))


class DataAnalyzer:
    def __init__(self, metric_fn: Optional[Callable] = None,
                 metric_name: str = DEFAULT_METRIC,
                 num_workers: int = 1, worker_id: int = 0,
                 run_id: Optional[str] = None,
                 metrics: Optional[dict] = None):
        """``metrics={'name': fn, ...}`` analyzes SEVERAL metrics in one
        dataset pass (reference DataAnalyzer's metric_names/metric_functions
        lists); the single ``metric_fn``/``metric_name`` form is the
        one-metric special case."""
        self.metrics = dict(metrics) if metrics else {
            metric_name: metric_fn or _seqlen_metric}
        if metrics and (metric_fn is not None):
            raise ValueError("pass either metrics={...} or metric_fn, not both")
        # single-metric accessors kept for the existing API surface
        self.metric_name = next(iter(self.metrics))
        self.metric_fn = self.metrics[self.metric_name]
        self.num_workers = num_workers
        self.worker_id = worker_id
        # per-run nonce: (dataset_len, num_workers) alone would silently
        # merge a stale shard from a previous run over a same-shaped dataset.
        # Multi-host fan-outs must pass the SAME run_id to every worker and
        # to the reducer; the in-process run() generates one per call.
        self.run_id = run_id

    # -- map -------------------------------------------------------------
    def _shard_file(self, save_path: str, worker_id: int,
                    metric_name: Optional[str] = None) -> str:
        return os.path.join(
            save_path, f"{metric_name or self.metric_name}_w{worker_id}.npz")

    def run_map(self, dataset: Sequence, save_path: str,
                worker_id: Optional[int] = None) -> str:
        """Scan this worker's stride-shard ONCE, computing every metric;
        persist (indices, values) per metric."""
        wid = self.worker_id if worker_id is None else worker_id
        os.makedirs(save_path, exist_ok=True)
        idx = np.arange(wid, len(dataset), self.num_workers)
        # fetch each sample ONCE (disk/mmap datasets: k metrics must not
        # mean k decode passes)
        rows = []
        for i in idx:
            s = dataset[int(i)]
            rows.append([fn(s) for fn in self.metrics.values()])
        arr = np.asarray(rows, np.float64).reshape(len(idx),
                                                   len(self.metrics))
        out = None
        for col, name in enumerate(self.metrics):
            out_m = self._shard_file(save_path, wid, name)
            # fingerprint guards the reduce against merging shards from a
            # different analysis run left behind in the same save_path
            np.savez(out_m, indices=idx, values=arr[:, col],
                     dataset_len=np.int64(len(dataset)),
                     num_workers=np.int64(self.num_workers),
                     run_id=np.asarray(self.run_id or ""))
            if name == self.metric_name:
                out = out_m
        return out

    # -- reduce ----------------------------------------------------------
    def run_reduce(self, save_path: str,
                   metric_name: Optional[str] = None) -> str:
        """Merge every worker shard into the aligned value/order arrays."""
        metric_name = metric_name or self.metric_name
        parts = [self._shard_file(save_path, w, metric_name)
                 for w in range(self.num_workers)]
        missing = [p for p in parts if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"reduce before map finished: missing {missing}")
        loaded = []
        fingerprints = set()
        for p in parts:
            with np.load(p) as z:
                loaded.append((z["indices"], z["values"]))
                rid = str(z["run_id"][()]) if "run_id" in z.files else ""
                fingerprints.add((int(z["dataset_len"]),
                                  int(z["num_workers"]), rid))
        want_rid = self.run_id or next(iter(fingerprints))[2]
        if len(fingerprints) != 1 or next(iter(
                fingerprints))[1] != self.num_workers or \
                next(iter(fingerprints))[2] != want_rid:
            raise ValueError(
                f"shard fingerprints disagree ({sorted(fingerprints)}, "
                f"reduce num_workers={self.num_workers}, "
                f"run_id={want_rid!r}) — stale shard "
                "files from a previous analysis in this save_path?")
        n = next(iter(fingerprints))[0]
        values = np.full(n, np.nan)
        for idx, vals in loaded:
            values[idx] = vals
        if np.isnan(values).any():
            raise ValueError("reduce found sample indices no worker covered "
                             "— num_workers mismatch between map and reduce?")
        vpath = os.path.join(save_path, f"{metric_name}_values.npy")
        np.save(vpath, values)
        return vpath

    # -- convenience: in-process parallel map + reduce -------------------
    def run(self, dataset: Sequence, save_path: str) -> np.ndarray:
        if self.run_id is None:
            import uuid

            self.run_id = uuid.uuid4().hex
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            list(pool.map(lambda w: self.run_map(dataset, save_path, w),
                          range(self.num_workers)))
        for name in self.metrics:
            self.run_reduce(save_path, name)
        return load_metric_values(save_path, self.metric_name)

    def run_multi(self, dataset: Sequence, save_path: str) -> dict:
        """One dataset pass, every metric merged:
        ``{name: aligned values array}``."""
        self.run(dataset, save_path)
        return {name: load_metric_values(save_path, name)
                for name in self.metrics}


def load_metric_values(save_path: str,
                       metric_name: str = DEFAULT_METRIC) -> np.ndarray:
    """The ``sizes`` array for CurriculumBatchSampler."""
    return np.load(os.path.join(save_path, f"{metric_name}_values.npy"))
