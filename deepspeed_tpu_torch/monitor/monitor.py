"""Monitor backends (counterpart of ``deepspeed_tpu/monitor/monitor.py``;
reference ``deepspeed/monitor/monitor.py:13,29``).

``MonitorMaster`` fans out ``(name, value, step)`` events to TensorBoard /
W&B / CSV writers on rank 0 of ``torch.distributed`` (every process when
there is no process group).  TensorBoard uses ``torch.utils.tensorboard``;
W&B is imported only when enabled, and both external backends degrade to a
warning when unavailable.  The CSV writer's files are the JAX package's,
byte for byte: one ``<name with '/' as '_'>.csv`` per event name, a
``step,value`` header, one ``{step},{value}`` line per event.
"""
from __future__ import annotations

import os
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from ..utils.logging import logger

Event = Tuple[str, float, int]


class Monitor:
    def __init__(self, monitor_config):
        self.monitor_config = monitor_config

    def write_events(self, event_list: List[Event]) -> None:
        raise NotImplementedError

    def write_report(self, name: str, text: str) -> None:
        """Freeform diagnostic report.  Backends that can persist text do;
        the default is the log, so a report is never silently dropped."""
        logger.error("monitor report [%s]:\n%s", name, text)


class TensorBoardMonitor(Monitor):
    def __init__(self, tensorboard_config):
        super().__init__(tensorboard_config)
        self.summary_writer = None
        if not tensorboard_config.enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            log_dir = os.path.join(tensorboard_config.output_path or "./runs",
                                   tensorboard_config.job_name)
            self.summary_writer = SummaryWriter(log_dir=log_dir)
        except Exception as e:  # pragma: no cover
            logger.warning(f"tensorboard writer unavailable: {e}")

    def write_events(self, event_list: List[Event]) -> None:
        if self.summary_writer is None:
            return
        for name, value, step in event_list:
            self.summary_writer.add_scalar(name, value, step)
        self.summary_writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, wandb_config):
        super().__init__(wandb_config)
        self.enabled = wandb_config.enabled
        if self.enabled:
            try:
                import wandb

                wandb.init(project=wandb_config.project, group=wandb_config.group,
                           entity=wandb_config.team)
                self._wandb = wandb
            except Exception as e:  # pragma: no cover
                logger.warning(f"wandb unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in event_list:
            self._wandb.log({name: value}, step=step)


class csvMonitor(Monitor):
    def __init__(self, csv_config):
        super().__init__(csv_config)
        self.enabled = csv_config.enabled
        self.log_dir = None
        self.filenames: dict = {}
        if self.enabled:
            self.log_dir = os.path.join(csv_config.output_path or "./csv_logs",
                                        csv_config.job_name)
            os.makedirs(self.log_dir, exist_ok=True)

    def write_events(self, event_list: List[Event]) -> None:
        if not self.enabled:
            return
        for name, value, step in event_list:
            fname = os.path.join(self.log_dir, name.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a") as f:
                if new:
                    f.write("step,value\n")
                f.write(f"{step},{value}\n")

    def write_report(self, name: str, text: str) -> None:
        if not self.enabled:
            return
        fname = os.path.join(self.log_dir, name.replace("/", "_") + ".txt")
        with open(fname, "a") as f:
            f.write(text + "\n")


class InMemoryMonitor(Monitor):
    """Event sink that keeps ``(name, value, step)`` tuples in memory.

    For tests and tools that assert on an event stream without filesystem
    or backend setup.

    **Bounded**: ``events`` is a ring of the newest ``max_events``
    records; evictions are counted on ``dropped_events`` rather than
    silent.  ``series()``/``latest()`` read the retained window.

    **Thread-safe**: writes and snapshot reads hold one lock (reads copy,
    so iteration never races an append)."""

    DEFAULT_MAX_EVENTS = 65536
    DEFAULT_MAX_REPORTS = 256   # reports carry multi-KB flight dumps

    def __init__(self, monitor_config=None, max_events: Optional[int] = None,
                 max_reports: Optional[int] = None):
        super().__init__(monitor_config)
        if max_events is None:
            max_events = self.DEFAULT_MAX_EVENTS
        if max_events < 1:
            raise ValueError(f"max_events={max_events} must be >= 1")
        self.max_events = int(max_events)
        self.max_reports = int(max_reports if max_reports is not None
                               else self.DEFAULT_MAX_REPORTS)
        self.events: Deque[Event] = deque(maxlen=self.max_events)
        self.reports: Deque[Tuple[str, str]] = deque(maxlen=self.max_reports)
        self.dropped_events = 0
        self.dropped_reports = 0
        # name -> newest value, maintained on write: latest() is O(1)
        # instead of a full ring copy and scan.  Bounded by the number of
        # distinct gauge names, not by traffic.
        self._latest: Dict[str, float] = {}
        self._lock = threading.Lock()

    def write_events(self, event_list: List[Event]) -> None:
        with self._lock:
            for ev in event_list:
                if len(self.events) == self.max_events:
                    self.dropped_events += 1
                self.events.append(ev)
                self._latest[ev[0]] = ev[1]

    def write_report(self, name: str, text: str) -> None:
        with self._lock:
            if len(self.reports) == self.max_reports:
                self.dropped_reports += 1
            self.reports.append((name, text))

    def events_snapshot(self) -> List[Event]:
        """Locked copy of the retained events — what an exporter on another
        thread must read instead of iterating ``events`` directly."""
        with self._lock:
            return list(self.events)

    def series(self, name: str) -> List[Tuple[int, float]]:
        """[(step, value)] of every retained event with this name, in
        write order."""
        snapshot = self.events_snapshot()
        return [(step, value) for (n, value, step) in snapshot if n == name]

    def latest(self, name: str) -> Optional[float]:
        """Most recent value of a gauge, or None if it never fired.  O(1):
        read from the write-maintained map, which remembers a name even
        after its events rotate out of the ring."""
        with self._lock:
            return self._latest.get(name)

    def latest_map(self) -> Dict[str, float]:
        """Locked copy of name -> newest value ever written (a gauge
        written once stays readable after its events rotate out of the
        ring)."""
        with self._lock:
            return dict(self._latest)


class MonitorMaster(Monitor):
    """Rank-0 fan-out to all enabled writers (reference monitor.py:29)."""

    def __init__(self, monitor_config):
        super().__init__(monitor_config)
        import torch.distributed as dist

        self._is_writer = (not (dist.is_available() and dist.is_initialized())
                           or dist.get_rank() == 0)
        self.tb_monitor = TensorBoardMonitor(monitor_config.tensorboard) if self._is_writer else None
        self.wandb_monitor = WandbMonitor(monitor_config.wandb) if self._is_writer else None
        self.csv_monitor = csvMonitor(monitor_config.csv_monitor) if self._is_writer else None

    def write_events(self, event_list: List[Event]) -> None:
        if not self._is_writer:
            return
        for mon in (self.tb_monitor, self.wandb_monitor, self.csv_monitor):
            if mon is not None:
                mon.write_events(event_list)

    def write_report(self, name: str, text: str) -> None:
        # every process may report; csv persists on the writer, the log
        # carries it everywhere
        logger.error("monitor report [%s]:\n%s", name, text)
        if self.csv_monitor is not None:
            self.csv_monitor.write_report(name, text)
