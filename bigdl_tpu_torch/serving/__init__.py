from .batching import (DeadlineExceeded, EngineStopped, QueueFull, Request,
                       ServeFuture, assemble)
from .decode_scheduler import (DecodeScheduler, LMRequest,
                               decode_scheduler_threads_alive,
                               prefill_padded_end, prefill_schedule)
from .engine import THREAD_NAME, ServingEngine, serving_threads_alive
from .kv_cache import (HostKVPool, HostPoolOOM, KVCacheOOM, KVSwapManager,
                       PagedKVCache, blocks_for_tokens,
                       kv_swap_threads_alive)
from .prefix_cache import PrefixCache, chain_keys
from .registry import ModelRegistry, ModelVersion
from .router import PriorityClass, Router, router_threads_alive
# the fleet across processes: replica agents behind the same Router,
# membership over beaten files, tensors over a framed socket transport,
# disaggregated prefill / decode with a verified KV handoff, and the
# reconcile loop that scales it
from .transport import (TransportClient, TransportClosed, TransportServer,
                        transport_threads_alive)
from .fleet import (DisaggregatedFleet, FleetMonitor, KVHandoffError,
                    RemoteReplica, ReplicaAgent, discover,
                    fleet_threads_alive, read_member, wait_for_members,
                    warm_replica)
from .controller import (FleetController, ScalePolicy,
                         controller_threads_alive)
# the failure classification the serving retries branch on is the
# trainer's (parallel.failure)
from ..parallel.failure import TransientDeviceError

__all__ = ["DeadlineExceeded", "EngineStopped", "QueueFull", "Request",
           "ServeFuture", "assemble", "DecodeScheduler", "LMRequest",
           "decode_scheduler_threads_alive", "prefill_padded_end",
           "prefill_schedule", "ServingEngine", "serving_threads_alive",
           "HostKVPool", "HostPoolOOM", "KVCacheOOM", "KVSwapManager",
           "PagedKVCache", "blocks_for_tokens", "kv_swap_threads_alive",
           "PrefixCache", "chain_keys", "ModelRegistry", "ModelVersion",
           "PriorityClass", "Router", "router_threads_alive", "THREAD_NAME",
           "TransportClient", "TransportClosed", "TransportServer",
           "transport_threads_alive", "DisaggregatedFleet", "FleetMonitor",
           "KVHandoffError", "RemoteReplica", "ReplicaAgent", "discover",
           "fleet_threads_alive", "read_member", "wait_for_members",
           "warm_replica", "FleetController", "ScalePolicy",
           "controller_threads_alive", "TransientDeviceError"]
