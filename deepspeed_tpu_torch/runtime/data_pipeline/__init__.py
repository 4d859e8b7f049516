"""Data efficiency suite (counterpart of ``deepspeed_tpu/runtime/data_pipeline``;
reference ``deepspeed/runtime/data_pipeline/``): curriculum learning,
curriculum-aware sampling, memmap indexed datasets, random layerwise token
dropping."""
from .curriculum_scheduler import CurriculumScheduler
from .data_analyzer import DataAnalyzer, load_metric_values
from .data_sampler import CurriculumBatchSampler, MultiMetricCurriculumSampler
from .indexed_dataset import MMapIndexedDataset, MMapIndexedDatasetBuilder

__all__ = ["CurriculumScheduler", "CurriculumBatchSampler",
           "MultiMetricCurriculumSampler", "DataAnalyzer", "load_metric_values",
           "MMapIndexedDataset", "MMapIndexedDatasetBuilder"]
