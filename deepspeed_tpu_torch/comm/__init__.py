"""The comm facade (counterpart of ``deepspeed_tpu.comm``)."""
from .comm import *  # noqa: F401,F403 - torch.distributed-shaped facade
from .comm import (init_distributed, destroy_process_group, is_initialized,
                   get_rank, get_world_size, get_local_rank, barrier,
                   broadcast_object, all_reduce, all_gather, reduce_scatter,
                   all_to_all, ppermute, send_recv_next, send_recv_prev,
                   broadcast, axis_index, get_axis_size, ReduceOp, configure,
                   get_comms_logger, log_summary, timed_op)
