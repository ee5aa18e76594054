from .flash import flash_attention, flash_chunk_attention, paged_attention
from .moe import top1_routing
from .mesh import (make_mesh, make_hybrid_mesh, data_parallel_mesh,
                   get_default_mesh, set_default_mesh, axis_size)
from .collective import (all_reduce_sum, all_reduce_mean, all_gather,
                         reduce_scatter, ppermute_ring, all_to_all, psum,
                         pmean)
from .allreduce import (AllReduceParameter, FP16CompressPolicy,
                        sparse_embedding_grad_allreduce)
from .sharding import (replicated, data_sharding, shard_batch, shard_params,
                       surviving_devices, mesh_after_loss)
from .failure import (probe_mesh, MeshProbeResult, Heartbeat, HeartbeatLost,
                      StragglerMonitor, TransientDeviceError, TrainingHalted,
                      FaultPolicy, classify_failure, TRANSIENT, PERMANENT)
from .elastic import (ElasticRunner, find_latest_checkpoint,
                      data_parallel_factory)

__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention",
           "top1_routing", "make_mesh", "make_hybrid_mesh",
           "data_parallel_mesh", "get_default_mesh", "set_default_mesh",
           "axis_size", "all_reduce_sum", "all_reduce_mean", "all_gather",
           "reduce_scatter", "ppermute_ring", "all_to_all", "psum", "pmean",
           "AllReduceParameter", "FP16CompressPolicy",
           "sparse_embedding_grad_allreduce", "replicated", "data_sharding",
           "shard_batch", "shard_params", "surviving_devices",
           "mesh_after_loss", "probe_mesh", "MeshProbeResult", "Heartbeat",
           "HeartbeatLost", "StragglerMonitor", "TransientDeviceError",
           "TrainingHalted", "FaultPolicy", "classify_failure", "TRANSIENT",
           "PERMANENT", "ElasticRunner", "find_latest_checkpoint",
           "data_parallel_factory"]
