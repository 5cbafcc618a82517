"""The paper's testbed: a Memcached-faithful slab-allocator simulator."""
from repro_torch.memcached.eviction import (ColdestLRU, EvictionPolicy,
                                            RankedPageEviction, SegmentedLRU,
                                            make_policy)
from repro_torch.memcached.metrics import WasteComparison, compare_schedules
from repro_torch.memcached.slab_allocator import (ReconfigureReport,
                                                  SlabAllocator, SlabStats,
                                                  run_workload)
from repro_torch.memcached.traffic import (TenantOp, all_paper_workloads,
                                           diurnal_multimodal_traffic,
                                           diurnal_traffic, drift_traffic,
                                           fleet_stream,
                                           multitenant_phased_ops,
                                           paper_histogram, paper_traffic,
                                           phase_shift_traffic,
                                           zipfian_rereference_ops)

__all__ = [
    "WasteComparison", "compare_schedules", "ReconfigureReport",
    "SlabAllocator", "SlabStats", "run_workload", "all_paper_workloads",
    "diurnal_multimodal_traffic",
    "diurnal_traffic", "drift_traffic", "paper_histogram", "paper_traffic",
    "phase_shift_traffic", "TenantOp", "fleet_stream",
    "multitenant_phased_ops",
    "EvictionPolicy", "ColdestLRU", "SegmentedLRU", "RankedPageEviction",
    "make_policy", "zipfian_rereference_ops",
]
