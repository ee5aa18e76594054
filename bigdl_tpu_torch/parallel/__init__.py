from .flash import (flash_attention, flash_chunk_attention, paged_attention,
                    paged_serving_context)
from .moe import moe_ffn, top1_routing
from .chaos import ChaosError, ChaosPlan
from .mesh import (make_mesh, make_hybrid_mesh, data_parallel_mesh,
                   get_default_mesh, set_default_mesh, axis_size)
from .collective import (all_reduce_sum, all_reduce_mean, all_gather,
                         reduce_scatter, ppermute_ring, all_to_all, psum,
                         pmean)
from .allreduce import (AllReduceParameter, FP16CompressPolicy,
                        sparse_embedding_grad_allreduce)
from .sharding import (replicated, data_sharding, shard_batch, shard_params,
                       tp_linear_rules, transformer_tp_specs, fsdp_specs,
                       surviving_devices, mesh_after_loss,
                       serving_batch_spec, serving_param_specs,
                       place_with_specs, batch_shard_count,
                       SERVING_BATCH_AXES, gather_param)
from .ring_attention import ring_attention, make_ring_attention
from .ring_flash import ring_flash_attention, make_ring_flash_attention
from .seq_all_to_all import a2a_attention
from .seq_decode import make_seq_sharded_decoder
from .pipeline import gpipe, stack_stage_params, unstack_stage_params
from .failure import (probe_mesh, MeshProbeResult, Heartbeat, HeartbeatLost,
                      StragglerMonitor, TransientDeviceError, TrainingHalted,
                      FaultPolicy, classify_failure, TRANSIENT, PERMANENT)
from .elastic import (ElasticRunner, find_latest_checkpoint,
                      data_parallel_factory)

__all__ = ["flash_attention", "flash_chunk_attention", "paged_attention",
           "paged_serving_context", "moe_ffn", "top1_routing", "make_mesh", "make_hybrid_mesh",
           "data_parallel_mesh", "get_default_mesh", "set_default_mesh",
           "axis_size", "all_reduce_sum", "all_reduce_mean", "all_gather",
           "reduce_scatter", "ppermute_ring", "all_to_all", "psum", "pmean",
           "AllReduceParameter", "FP16CompressPolicy",
           "sparse_embedding_grad_allreduce", "replicated", "data_sharding",
           "shard_batch", "shard_params", "surviving_devices",
           "mesh_after_loss", "tp_linear_rules", "transformer_tp_specs",
           "fsdp_specs", "serving_batch_spec", "serving_param_specs",
           "place_with_specs", "batch_shard_count", "SERVING_BATCH_AXES",
           "gather_param", "ring_attention", "make_ring_attention",
           "ring_flash_attention", "make_ring_flash_attention",
           "a2a_attention", "make_seq_sharded_decoder", "gpipe",
           "stack_stage_params", "unstack_stage_params", "probe_mesh", "MeshProbeResult", "Heartbeat",
           "HeartbeatLost", "StragglerMonitor", "TransientDeviceError",
           "TrainingHalted", "FaultPolicy", "classify_failure", "TRANSIENT",
           "PERMANENT", "ElasticRunner", "find_latest_checkpoint",
           "data_parallel_factory", "ChaosError", "ChaosPlan"]
