"""Core: the paper's contribution — learning slab-class schedules.

Public surface:
    distribution — traffic models + the paper's Tables 1-5 operating points
    waste        — exact + torch waste objectives
    hillclimb    — paper's Algorithm 1 + batched/parallel/multi-restart
    dp_optimal   — exact global optimum (tests the paper's §6.3 claim)
    anneal       — simulated-annealing variant
    slab_policy  — SlabPolicy / SlabSchedule, the composable API
    observe      — streaming decayed size sketch + drift distances
    forecast     — DemandForecaster / Reactive, the predictive seam
    controller   — SlabController, the online observe→detect→refit loop
    arbiter      — ResourcePool/PagePool + TenantArbiter, cross-tenant
                   resource arbitration over per-tenant controllers
    fleet        — FleetState, the per-tenant arbiter state stacked
                   into [n_tenants, ...] arrays (TenantArbiter(fleet=True))
"""
from repro_torch.core.distribution import (PAGE_SIZE, PAPER_N_ITEMS,
                                           PAPER_WORKLOADS, PaperWorkload,
                                           dense_histogram,
                                           lognormal_params_from_moments,
                                           merge_histograms,
                                           sample_lognormal_sizes,
                                           sample_multimodal_sizes,
                                           size_histogram)
from repro_torch.core.dp_optimal import (DPResult, dp_optimal,
                                         dp_optimal_bruteforce)
from repro_torch.core.hillclimb import (MIN_CHUNK, SearchResult,
                                        multi_restart, paper_hillclimb,
                                        parallel_hillclimb)
from repro_torch.core.anneal import anneal
from repro_torch.core.slab_policy import (SlabPolicy, SlabSchedule,
                                          covering_default_classes,
                                          default_memcached_schedule,
                                          schedule_with_default_tail)
from repro_torch.core.waste import (default_waste_fraction,
                                    per_class_waste_exact, uncovered_charge,
                                    utilization_exact, waste_batch_torch,
                                    waste_exact, waste_torch)
from repro_torch.core.observe import (DecayedSizeHistogram, DeviceSizeSketch,
                                      histogram_distance,
                                      histogram_distance_device)
from repro_torch.core.forecast import (DemandForecaster, Forecast, Reactive,
                                       acf_period_batch, blend_histograms)
from repro_torch.core.controller import (ControllerConfig, RefitDecision,
                                         SlabController)
from repro_torch.core.arbiter import (PagePool, ResourcePool, TenantArbiter,
                                      TenantPages, TransferDecision)
from repro_torch.core.fleet import FleetSketchView, FleetState

__all__ = [
    "PAGE_SIZE", "PAPER_N_ITEMS", "PAPER_WORKLOADS", "PaperWorkload",
    "dense_histogram", "lognormal_params_from_moments", "merge_histograms",
    "sample_lognormal_sizes", "sample_multimodal_sizes", "size_histogram",
    "DPResult", "dp_optimal", "dp_optimal_bruteforce",
    "MIN_CHUNK", "SearchResult", "multi_restart", "paper_hillclimb",
    "parallel_hillclimb", "anneal",
    "SlabPolicy", "SlabSchedule", "covering_default_classes",
    "default_memcached_schedule", "schedule_with_default_tail",
    "default_waste_fraction", "per_class_waste_exact", "uncovered_charge",
    "utilization_exact", "waste_batch_torch", "waste_exact", "waste_torch",
    "DecayedSizeHistogram", "DeviceSizeSketch",
    "histogram_distance", "histogram_distance_device",
    "DemandForecaster", "Forecast", "Reactive", "acf_period_batch",
    "blend_histograms",
    "ControllerConfig", "RefitDecision", "SlabController",
    "PagePool", "ResourcePool", "TenantArbiter", "TenantPages",
    "TransferDecision", "FleetSketchView", "FleetState",
]
