"""Curriculum-aware batch sampling (counterpart of
``deepspeed_tpu/runtime/data_pipeline/data_sampler.py``; reference
``runtime/data_pipeline/data_sampling/data_sampler.py:36``
``DeepSpeedDataSampler``).

The sampler yields *index batches* (numpy, seeded from the config's seed:
the JAX package's streams, index for index) whose difficulty metric
(default: document length) is within the curriculum's current difficulty.
Buckets are precomputed with one argsort; each ``set_difficulty`` narrows or
widens the eligible prefix, so stepping the curriculum costs O(1).  Shuffling
is deterministic per (seed, epoch) like the reference, and state round-trips
for checkpoint/resume (``state_dict``/``load_state_dict``).
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from .curriculum_scheduler import CurriculumScheduler


class CurriculumBatchSampler:
    def __init__(self, sizes: Sequence[int], batch_size: int,
                 curriculum: Optional[CurriculumScheduler] = None,
                 seed: int = 1234, drop_last: bool = True):
        self.sizes = np.asarray(sizes)
        self.batch_size = batch_size
        self.curriculum = curriculum
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.consumed_batches = 0
        # ascending difficulty; eligible set is always a prefix of this order
        self._order = np.argsort(self.sizes, kind="stable")
        self._sorted_sizes = self.sizes[self._order]

    def _eligible(self) -> np.ndarray:
        if self.curriculum is None:
            return self._order
        diff = self.curriculum.get_current_difficulty()
        cutoff = int(np.searchsorted(self._sorted_sizes, diff, side="right"))
        if cutoff < self.batch_size and not self.drop_last:
            cutoff = min(self.batch_size, len(self._order))
        return self._order[:cutoff]

    def __iter__(self) -> Iterator[List[int]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        while True:
            if self.curriculum is not None:
                self.curriculum.update_difficulty(self.consumed_batches)
            pool = self._eligible()
            if len(pool) < self.batch_size and self.drop_last:
                raise ValueError(
                    f"curriculum difficulty "
                    f"{self.curriculum.get_current_difficulty() if self.curriculum else '-'} "
                    f"admits only {len(pool)} samples < batch {self.batch_size}")
            batch = rng.choice(pool, size=self.batch_size,
                               replace=len(pool) < self.batch_size)
            self.consumed_batches += 1
            yield [int(i) for i in batch]
            if self.consumed_batches % max(len(self.sizes) // self.batch_size, 1) == 0:
                self.epoch += 1
                rng = np.random.default_rng(self.seed + self.epoch)

    # -- checkpoint/resume (reference state_dict contract) ---------------
    def state_dict(self):
        return {"epoch": self.epoch, "consumed_batches": self.consumed_batches,
                "seed": self.seed,
                "curriculum": (self.curriculum.get_state()
                               if self.curriculum else None)}

    def load_state_dict(self, state):
        self.epoch = state["epoch"]
        self.consumed_batches = state["consumed_batches"]
        self.seed = state["seed"]
        if self.curriculum is not None and state.get("curriculum"):
            self.curriculum.set_state(state["curriculum"])


class MultiMetricCurriculumSampler:
    """Cluster-bucketed multi-metric curriculum sampling (reference
    ``DeepSpeedDataSampler``, data_sampling/data_sampler.py:36).

    Each metric carries its own values array, curriculum scheduler,
    difficulty type (``value`` — thresholds in metric units — or
    ``percentile`` — thresholds in 0..max_difficulty rank units) and
    clustering type (``schedule_based`` participates in clustering;
    ``single_cluster`` never constrains).  Whenever any difficulty
    advances, the NEWLY-eligible samples (the intersection of per-metric
    eligible sets minus everything already clustered) form a new shuffled
    cluster; every batch then draws from ALL clusters with probability
    proportional to cluster size, sequentially within each cluster with a
    reshuffle on wrap-around — exactly the reference's sampling scheme,
    with in-memory numpy clusters instead of mmap files (the datasets feed
    through the engine's loader, not a 100M-doc mmap store).

    Distributed state: the full sampler state (difficulties, clusters,
    positions, RNG bit-generator state, consumed count) round-trips via
    ``state_dict``/``load_state_dict``, which the engine persists inside
    checkpoints — a resumed run continues the SAME sample stream.
    """

    def __init__(self, metrics: dict, batch_size: int, seed: int = 1234):
        if not metrics:
            raise ValueError("MultiMetricCurriculumSampler needs >=1 metric")
        self.metric_names = sorted(metrics)
        self.metrics = metrics
        n_set = {len(np.asarray(m["values"])) for m in metrics.values()}
        if len(n_set) != 1:
            raise ValueError(f"metric value arrays disagree on dataset "
                             f"size: {sorted(n_set)}")
        self.n = n_set.pop()
        self.batch_size = batch_size
        self.seed = seed
        self.consumed_batches = 0
        self.np_rng = np.random.default_rng(seed)
        self.current_difficulties = {m: None for m in self.metric_names}
        self.clusters: List[np.ndarray] = []
        self.positions: List[int] = []
        # precomputed ascending order per metric (percentile eligibility is
        # a prefix of this; value eligibility via searchsorted)
        self._order = {m: np.argsort(np.asarray(metrics[m]["values"]),
                                     kind="stable")
                      for m in self.metric_names}
        self._sorted_vals = {m: np.asarray(metrics[m]["values"])[self._order[m]]
                             for m in self.metric_names}

    # -- eligibility ------------------------------------------------------
    def _eligible(self, name: str, difficulty) -> np.ndarray:
        spec = self.metrics[name]
        if spec.get("clustering_type", "schedule_based") == "single_cluster":
            return np.arange(self.n)
        if spec.get("difficulty_type", "value") == "percentile":
            maxd = spec["scheduler"].state["max_difficulty"]
            cutoff = int(self.n * min(difficulty / maxd, 1.0))
            return self._order[name][:cutoff]
        cutoff = int(np.searchsorted(self._sorted_vals[name], difficulty,
                                     side="right"))
        return self._order[name][:cutoff]

    def _maybe_new_cluster(self) -> None:
        changed = False
        for m in self.metric_names:
            d = self.metrics[m]["scheduler"].update_difficulty(
                self.consumed_batches)
            if d != self.current_difficulties[m]:
                self.current_difficulties[m] = d
                changed = True
        if not changed and self.clusters:
            return
        eligible = None
        for m in self.metric_names:
            e = self._eligible(m, self.current_difficulties[m])
            eligible = e if eligible is None else np.intersect1d(
                eligible, e, assume_unique=True)
        for c in self.clusters:
            eligible = np.setdiff1d(eligible, c, assume_unique=True)
        if eligible is not None and len(eligible):
            self.np_rng.shuffle(eligible)
            self.clusters.append(eligible)
            self.positions.append(0)

    # -- cluster draws ----------------------------------------------------
    def _draw(self, cidx: int, k: int) -> List[int]:
        out: List[int] = []
        while len(out) < k:   # looped wrap: k may exceed the cluster size
            c, pos = self.clusters[cidx], self.positions[cidx]
            take = min(k - len(out), len(c) - pos)
            out += [int(i) for i in c[pos:pos + take]]
            self.positions[cidx] = pos + take
            if self.positions[cidx] >= len(c) and len(out) < k:
                c = c.copy()                    # reshuffle and keep drawing
                self.np_rng.shuffle(c)
                self.clusters[cidx] = c
                self.positions[cidx] = 0
        return out

    def __iter__(self) -> Iterator[List[int]]:
        while True:
            self._maybe_new_cluster()
            if not self.clusters:
                raise ValueError(
                    "no samples eligible at the initial difficulties "
                    f"{self.current_difficulties}")
            sizes = np.asarray([len(c) for c in self.clusters], np.float64)
            weights = sizes / sizes.sum()
            picks = self.np_rng.choice(len(self.clusters), self.batch_size,
                                       replace=True, p=weights)
            counts = np.bincount(picks, minlength=len(self.clusters))
            batch: List[int] = []
            for cidx, k in enumerate(counts):
                if k:
                    batch += self._draw(cidx, int(k))
            self.consumed_batches += 1
            yield batch

    # -- checkpointed distributed state -----------------------------------
    def state_dict(self):
        return {
            "consumed_batches": self.consumed_batches,
            "seed": self.seed,
            "current_difficulties": dict(self.current_difficulties),
            "clusters": [c.tolist() for c in self.clusters],
            "positions": list(self.positions),
            "rng_state": self.np_rng.bit_generator.state,
            "schedulers": {m: self.metrics[m]["scheduler"].get_state()
                           for m in self.metric_names},
        }

    def load_state_dict(self, state):
        self.consumed_batches = state["consumed_batches"]
        self.seed = state["seed"]
        self.current_difficulties = dict(state["current_difficulties"])
        self.clusters = [np.asarray(c, np.int64) for c in state["clusters"]]
        self.positions = list(state["positions"])
        self.np_rng.bit_generator.state = state["rng_state"]
        for m, s in state.get("schedulers", {}).items():
            if m in self.metrics:
                self.metrics[m]["scheduler"].set_state(s)
