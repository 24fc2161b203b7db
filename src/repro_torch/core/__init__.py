"""Host-side placement math (numpy) for the serve path's Theorem-1 step."""
from .activation import activation_probs, esp, esp_prefix_table
from .device_placement import (DevicePlacementPlan, TorusSpec,
                               expected_dispatch_cost, identity_plan,
                               plan_expert_devices)
from .objective import layer_latency_closed_form
from .placement import theorem1_assignment

__all__ = [
    "activation_probs", "esp", "esp_prefix_table", "DevicePlacementPlan",
    "TorusSpec", "expected_dispatch_cost", "identity_plan",
    "plan_expert_devices", "layer_latency_closed_form", "theorem1_assignment",
]
