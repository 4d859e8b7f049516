"""Pipeline parallelism (counterpart of ``deepspeed_tpu/runtime/pipe/``;
reference ``runtime/pipe/`` and ``deepspeed/pipe``): the schedules, the
executor that runs them (``executor.py``, the port's ``spmd.py``) and the
``PipelineModule`` authoring surface."""
from .executor import (AxisTransport, VirtualTransport, run_pipeline,
                       stage_layer_count)
from .module import LayerSpec, PipelineModule, TiedLayerSpec, partition_balanced
from .schedule import (BackwardPass, ForwardPass, GPipeSchedule, InferenceSchedule,
                       LoadMicroBatch, OptimizerStep, PipeSchedule, RecvActivation,
                       RecvGrad, ReduceGrads, ReduceTiedGrads, SendActivation,
                       SendGrad, TrainSchedule)

__all__ = ["run_pipeline", "stage_layer_count", "VirtualTransport", "AxisTransport",
           "LayerSpec", "PipelineModule", "TiedLayerSpec", "partition_balanced",
           "PipeSchedule", "TrainSchedule", "GPipeSchedule", "InferenceSchedule",
           "ForwardPass", "BackwardPass", "LoadMicroBatch", "OptimizerStep",
           "RecvActivation", "RecvGrad", "ReduceGrads", "ReduceTiedGrads",
           "SendActivation", "SendGrad"]
