"""Carry the reference's weights and state into the port.

``params_from_jax(cfg, params)`` takes the reference's parameter pytree
as nested dicts of numpy arrays (``jax.tree.map(np.asarray, params)`` on
the caller's side; this module imports no JAX) and returns the port's
parameters: the same arrays in the same layout, with the reference's
leading ``units`` axis unstacked into the per-layer list (shared experts
inside each unit's ``ffn["shared"]``), and the dense first block
(``params["first"]``) as it is.  Every leaf crosses as it is, in its
own dtype, so tied embeddings (no ``head``), the QKV bias leaves
(``b_q``, ``b_k``, ``b_v``), EP-slotted expert stacks ((V, d, f/frag)
and (V, f/frag, d)), blocks without ``norm2`` and ``ffn`` (``ffn="none"``)
and the recurrent mixers' f32 leaves arrive in the structure the port's
``init_params`` draws for the same config.  Any tree of the parameters'
structure crosses the same way: the reference's grads and its AdamW
moments (``mu``, ``nu``) become the port's.

The fleet simulator's state crosses the same way: ``plan_from_arrays``,
``schedule_from_arrays``, ``requests_from_arrays`` and
``topology_from_arrays`` take the reference's plans, schedules, request
traces and topology samples as dicts of numbers
(``dataclasses.asdict(obj)`` on the caller's side) and return the
port's dataclasses.  Only numbers cross, never reference objects.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.latency import TopologySample
from .core.placement import MultiExpertPlan, PlacementPlan
from .core.schedule import PlanSchedule
from .models.config import ModelConfig
from .models.model import check_supported, n_scan_units
from .traffic.requests import RequestBatch


def _tree(node, device, pick=None):
    if isinstance(node, dict):
        return {k: _tree(v, device, pick) for k, v in node.items()}
    a = np.asarray(node) if pick is None else np.asarray(node)[pick]
    return torch.from_numpy(np.array(a)).to(device)   # a copy: jax's are read-only


def params_from_jax(cfg: ModelConfig, params: dict, device="cuda") -> dict:
    """The reference's parameters (numpy leaves) as the port's parameters."""
    check_supported(cfg)
    dev = resolve_device(device)
    out = {k: _tree(params[k], dev)
           for k in ("embed", "final_norm", "head", "first") if k in params}
    units = params["units"]
    out["layers"] = [_tree(units[f"b{i}"], dev, pick=u)
                     for u in range(n_scan_units(cfg))
                     for i in range(len(cfg.pattern))]
    return out


def plan_from_arrays(d: dict) -> PlacementPlan | MultiExpertPlan:
    """A plan from ``gateways`` (L,), ``expert_sats`` (L, I) and ``name``;
    with ``experts_per_sat`` it is a multi-expert plan."""
    gateways = np.array(d["gateways"], dtype=np.int64)
    expert_sats = np.array(d["expert_sats"], dtype=np.int64)
    name = str(d.get("name", "plan"))
    if d.get("experts_per_sat") is not None:
        return MultiExpertPlan(gateways=gateways, expert_sats=expert_sats,
                               experts_per_sat=int(d["experts_per_sat"]),
                               name=name)
    return PlacementPlan(gateways=gateways, expert_sats=expert_sats,
                         name=name)


def schedule_from_arrays(d: dict) -> PlanSchedule:
    """A plan schedule from ``plans`` (plan dicts), ``slot_plan`` and
    ``name``."""
    return PlanSchedule(plans=[plan_from_arrays(p) for p in d["plans"]],
                        slot_plan=np.array(d["slot_plan"], dtype=np.int64),
                        name=str(d.get("name", "schedule")))


def requests_from_arrays(d: dict) -> RequestBatch:
    """A request trace from ``arrival_s``, ``prompt_len``, ``decode_len``
    and ``station``."""
    return RequestBatch(
        arrival_s=np.array(d["arrival_s"], dtype=np.float64),
        prompt_len=np.array(d["prompt_len"], dtype=np.int64),
        decode_len=np.array(d["decode_len"], dtype=np.int64),
        station=np.array(d["station"], dtype=np.int64))


def topology_from_arrays(d: dict) -> TopologySample:
    """A topology sample from ``edges``, ``edge_mask``, ``edge_latency``
    and ``n_sats``."""
    return TopologySample(edges=np.array(d["edges"], dtype=np.int64),
                          edge_mask=np.array(d["edge_mask"], dtype=bool),
                          edge_latency=np.array(d["edge_latency"],
                                                dtype=np.float64),
                          n_sats=int(d["n_sats"]))
