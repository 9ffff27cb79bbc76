"""Multi-process generation and training: meshes, collectives,
tensor-parallel shards, sequence parallelism and the sharded train step
over `torch.distributed`.

Counterpart of `audio_llama_tpu/parallel/`: the JAX package's `shard_map`
and GSPMD over a ('dp', 'fsdp', 'tp', 'sp') device mesh become one process
per mesh position (`mesh.py`), `lax` collectives become process-group
collectives, differentiable where training needs them (`collectives.py`),
the Megatron specs cut each rank's block out of a full tree
(`sharding.py`), and the ring of sequence-parallel training runs the
causal kernels per hop (`ring_kernel.py`; `ring_attention.py` is its plain
reference), and `sharded_train.py` holds the train and eval steps (import
it as a module: it imports the models, which import this package). fsdp
and sp x tp training are not ported yet.
"""

from . import distributed
from .mesh import MeshConfig, best_mesh_shape, build_mesh, make_mesh
from .seq_parallel import make_sp_encode, make_sp_generate
from .sharding import llama_specs, shard_frozen_for_generation, trainable_specs

__all__ = [
    "MeshConfig",
    "make_mesh",
    "build_mesh",
    "best_mesh_shape",
    "llama_specs",
    "trainable_specs",
    "shard_frozen_for_generation",
    "make_sp_encode",
    "make_sp_generate",
    "distributed",
]
