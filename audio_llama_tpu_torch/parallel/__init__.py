"""Multi-process generation: meshes, collectives, tensor-parallel shards and
sequence parallelism over `torch.distributed`.

Counterpart of the generation half of `audio_llama_tpu/parallel/`: the JAX
package's `shard_map` over a ('dp', 'fsdp', 'tp', 'sp') device mesh becomes
one process per mesh position (`mesh.py`), `lax` collectives become
process-group collectives (`collectives.py`), and the Megatron specs cut
each rank's block out of a full tree (`sharding.py`). The sharded trainer
is not ported yet.
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
