"""Process-group topology (counterpart of ``deepspeed_tpu.parallel``)."""
from .mesh import (MESH_AXES, ZERO_AXES, DATA_AXES, BATCH_AXES, MeshLayout,
                   ProcessTopology, build_mesh, initialize_mesh,
                   initialize_serving_mesh, get_mesh, get_layout, reset_mesh,
                   dp_world_size, resolve_engine_mesh, topology_from_mesh)
