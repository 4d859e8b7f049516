from .monitor import (InMemoryMonitor, Monitor, MonitorMaster,  # noqa: F401
                      TensorBoardMonitor, WandbMonitor, csvMonitor)
