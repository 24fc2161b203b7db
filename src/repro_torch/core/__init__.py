"""SpaceMoE core (counterpart of ``repro.core``): the constellation and
its time-varying topology, the conditional-Poisson activation model, the
two-level placement with the Theorem-1 rule, plan schedules, the
service-time model and its calibration on the port's kernels, the
batched plan-evaluation engine (PyTorch, on an explicit device) and the
token-generation simulator over it, plus the serve path's expert->device
placement.
"""
from .activation import (ActivationModel, activation_probs,
                         activation_probs_torch, esp, esp_prefix_table,
                         esp_prefix_table_torch, esp_torch, sample_topk,
                         sample_topk_torch, subset_pmf)
from .calibration import (ServiceModel, ServiceTable, calibrate, list_tables,
                          load_table, resolve_service_model, save_table,
                          verify_table)
from .constellation import (EARTH_RADIUS_M, SPEED_OF_LIGHT, Constellation,
                            ConstellationConfig)
from .device_placement import (DevicePlacementPlan, TorusSpec,
                               expected_dispatch_cost, identity_plan,
                               plan_expert_devices)
from .engine import (PlanBatch, ScheduleBatch, SimResult, contention_counts,
                     evaluate_plans, evaluate_schedules, hop_latency,
                     ingress_offsets, schedule_ingress_offsets)
from .latency import (ComputeConfig, LinkConfig, TopologySample,
                      expected_path_latency, gateway_distance_table,
                      sample_topology, source_distance_table)
from .objective import (brute_force_optimal, layer_latency_closed_form,
                        layer_latency_monte_carlo)
from .placement import (MultiExpertPlan, PlacementPlan, baseline_plans,
                        central_gateway, multi_expert_plan,
                        rand_intra_cg_plan, rand_intra_plan, rand_place_plan,
                        rank_plans, ring_subnets, spacemoe_plan,
                        subnet_routing_sets, theorem1_assignment)
from .schedule import (PlanSchedule, ScheduleMigration, as_schedule,
                       migration_between, migration_matrix, slot_of_time)
from .simulator import (simulate_token_generation,
                        simulate_token_generation_legacy)
from .workload import MoEWorkload

__all__ = [
    "ActivationModel", "activation_probs", "activation_probs_torch", "esp",
    "esp_torch", "esp_prefix_table", "esp_prefix_table_torch", "sample_topk",
    "sample_topk_torch", "subset_pmf",
    "ServiceModel", "ServiceTable", "calibrate", "list_tables", "load_table",
    "resolve_service_model", "save_table", "verify_table",
    "EARTH_RADIUS_M", "SPEED_OF_LIGHT", "Constellation", "ConstellationConfig",
    "DevicePlacementPlan", "TorusSpec", "expected_dispatch_cost",
    "identity_plan", "plan_expert_devices",
    "PlanBatch", "ScheduleBatch", "SimResult", "contention_counts",
    "evaluate_plans", "evaluate_schedules", "hop_latency", "ingress_offsets",
    "schedule_ingress_offsets",
    "ComputeConfig", "LinkConfig", "TopologySample", "expected_path_latency",
    "gateway_distance_table", "sample_topology", "source_distance_table",
    "brute_force_optimal", "layer_latency_closed_form",
    "layer_latency_monte_carlo",
    "MultiExpertPlan", "PlacementPlan", "baseline_plans", "central_gateway",
    "multi_expert_plan", "rand_intra_cg_plan", "rand_intra_plan",
    "rand_place_plan", "rank_plans", "ring_subnets", "spacemoe_plan",
    "subnet_routing_sets", "theorem1_assignment",
    "PlanSchedule", "ScheduleMigration", "as_schedule", "migration_between",
    "migration_matrix", "slot_of_time",
    "simulate_token_generation", "simulate_token_generation_legacy",
    "MoEWorkload",
]
