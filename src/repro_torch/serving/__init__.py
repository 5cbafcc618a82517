"""Serving: slab-pool KV allocation (the paper's technique), continuous
batching, and the offline-scale batched harness whose decode tick runs
through the port's attention and KV-scatter kernels."""
from repro_torch.serving.kv_slab_pool import (ALIGN, Allocation, KVSlabPool,
                                              KVTenantQuotaView, PoolStats,
                                              TenantTokens,
                                              default_pow2_classes,
                                              quantize_lengths,
                                              token_quota_arbiter)
from repro_torch.serving.offline_harness import HarnessResult, OfflineHarness
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           SimResult,
                                           lognormal_request_workload,
                                           queue_delay_stats)

__all__ = ["ALIGN", "Allocation", "KVSlabPool", "KVTenantQuotaView",
           "PoolStats", "TenantTokens",
           "default_pow2_classes", "quantize_lengths", "token_quota_arbiter",
           "ContinuousBatcher", "OfflineHarness", "HarnessResult",
           "Request", "SimResult", "lognormal_request_workload",
           "queue_delay_stats"]
