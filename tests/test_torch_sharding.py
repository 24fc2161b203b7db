"""The port's ``ShardingRules``, ``Parallel.resolve_moe``, ``ssm._pin`` and
production mesh against the reference's, on the CPU with no process
started.

The rules run on full-width structs of every architecture (the
reference's ``jax.eval_shape`` structs, the port's ``meta`` tensors from
``launch.steps``) on the two production mesh shapes, given as fake
meshes (``shape`` and ``axis_names`` are all the rules read), with
``zero_opt`` off and on.  The port's leaves have no stacked unit axis:
its layer j is the reference's ``units/b{j % len(pattern)}`` without the
leading unit dim, so its spec must be the reference's without the
leading ``None``, leaf by leaf, for params, optimizer moments, batches and
the caches of every decode cell.  Everything is compared exactly.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfgs
import repro.launch.steps as jsteps
import repro.models.model as jmodel
import repro.models.ssm as jssm
from repro.distributed.sharding import ShardingRules as JRules
from repro.models.frontends import batch_specs as jbatch_specs

import repro_torch.configs as tcfgs
import repro_torch.launch.steps as tsteps
import repro_torch.models.model as tmodel
import repro_torch.models.ssm as tssm
from repro_torch.distributed import ShardingRules
from repro_torch.distributed.sharding import PartitionSpec as P
from repro_torch.launch.mesh import data_axes, make_production_mesh
from repro_torch.models.frontends import batch_specs as tbatch_specs


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"pod_16x16": {"data": 16, "model": 16},
          "multipod_2x16x16": {"pod": 2, "data": 16, "model": 16}}
ARCHS = jcfgs.list_archs()


@functools.lru_cache(maxsize=None)
def _structs(arch):
    return (jsteps.param_structs(jcfgs.get_config(arch)),
            tsteps.param_structs(tcfgs.get_config(arch)))


def _rules(cls, cfg, mesh_name, zero_opt=False):
    mesh = FakeMesh(MESHES[mesh_name])
    return cls(cfg, mesh, data_axes=data_axes(mesh), zero_opt=zero_opt)


def _pairs(port, ref, width, path=(), ref_path=(), stacked=False):
    """(port path, port leaf, reference path, reference leaf, stacked) for
    every leaf; the port's layer j is the reference's
    ``units/b{j % width}``, whose leaves have a leading unit dim."""
    if not isinstance(port, dict):
        yield path, port, ref_path, ref, stacked
        return
    for k, v in port.items():
        if k == "layers":
            for j, layer in enumerate(v):
                yield from _pairs(layer, ref["units"][f"b{j % width}"], width,
                                  path + (k, j),
                                  ref_path + ("units", f"b{j % width}"), True)
        else:
            yield from _pairs(v, ref[k], width, path + (k,), ref_path + (k,),
                              stacked)


def _unstacked(ref, stacked):
    """A reference spec's entries or struct's shape without its unit dim."""
    full = tuple(ref) if isinstance(ref, JP) else tuple(ref.shape)
    if stacked and isinstance(ref, JP):
        assert full[0] is None
    return full[1:] if stacked else full


def _width(arch):
    return len(jcfgs.get_config(arch).pattern)


# --------------------------------------------------------------------- #
# ShardingRules: decisions, params, moments, batches, caches
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("zero_opt", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch, mesh_name, zero_opt):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jp, tp = _structs(arch)
    jr = _rules(JRules, jcfg, mesh_name, zero_opt)
    tr = _rules(ShardingRules, tcfg, mesh_name, zero_opt)
    jspecs, tspecs = jr.param_specs(jp), tr.param_specs(tp)
    w = _width(arch)
    seen = set()
    for path, got, ref_path, want, stacked in _pairs(tspecs, jspecs, w):
        key, ref_key = "/".join(map(str, path)), "/".join(ref_path)
        assert tuple(got) == _unstacked(want, stacked), key
        assert tr.decisions[key] == str(JP(*_unstacked(want, stacked)))
        assert jr.decisions[ref_key] == str(want)
        seen.add(ref_key)
    assert seen == set(jr.decisions)
    assert len(tr.decisions) == len(list(_pairs(tspecs, jspecs, w)))
    jopt = jr.opt_state_specs(jsteps.opt_structs(jp), jspecs)
    topt = tr.opt_state_specs(tsteps.opt_structs(tp), tspecs)
    assert tuple(topt["count"]) == tuple(jopt["count"]) == ()
    for moment in ("mu", "nu"):
        for path, got, _, want, st in _pairs(topt[moment], jopt[moment], w):
            assert tuple(got) == _unstacked(want, st), (moment, path)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_name):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jr = _rules(JRules, jcfg, mesh_name)
    tr = _rules(ShardingRules, tcfg, mesh_name)
    for shape in jcfgs.SHAPES.values():
        if not jcfgs.shape_applies(jcfg, shape)[0]:
            continue
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            jspecs = jr.cache_specs(jsteps.cache_structs(jcfg, b, s))
            tspecs = tr.cache_specs(tsteps.cache_structs(tcfg, b, s))
        else:
            jspecs = jr.batch_spec(jbatch_specs(jcfg, b, s))
            tspecs = tr.batch_spec(tbatch_specs(tcfg, b, s))
        pairs = list(_pairs(tspecs, jspecs, _width(arch)))
        assert pairs, shape.name
        for path, got, _, want, stacked in pairs:
            assert isinstance(got, P), (shape.name, path)
            assert tuple(got) == _unstacked(want, stacked), (shape.name, path)


def test_sharding_rules_divisibility_guards():
    """``tests/test_launch.py``'s three asserts, on the port's leaves."""
    class FakeMesh:
        shape = {"data": 4, "model": 16}
        axis_names = ("data", "model")

    cfg = tcfgs.get_config("granite-moe-3b-a800m")   # 40 experts: not / 16
    rules = ShardingRules(cfg, FakeMesh())
    leaf = torch.empty((40, 1536, 512), device="meta")
    spec = rules.param_spec(("layers", 0, "ffn", "w_gate"), leaf)
    # EP impossible (40 % 16 != 0) -> TP on d_ff instead
    assert spec == P(None, None, "model")

    cfg2 = tcfgs.get_config("deepseek-moe-16b")      # 64 experts: / 16
    rules2 = ShardingRules(cfg2, FakeMesh())
    spec2 = rules2.param_spec(("layers", 0, "ffn", "w_gate"),
                              torch.empty((64, 2048, 1408), device="meta"))
    assert spec2 == P("model", None, None)

    # batch=1 cache: batch unshardable -> context parallelism on seq
    cspec = rules2.cache_spec(("layers", 0, "k"),
                              torch.empty((1, 1024, 16, 128), device="meta"))
    assert cspec == P(None, "data", "model", None)


def test_placements_per_mesh_axis():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed.sharding import placements
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert placements(P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(P(None, "data"), mesh) == \
        (Replicate(), Shard(1), Replicate())
    assert placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        placements(P(("data", "pod")), mesh)


def test_partition_spec_prints_as_the_reference():
    for entries in [(), (None, "model"), ("data",), (("pod", "data"), None)]:
        assert str(P(*entries)) == str(JP(*entries)) == repr(P(*entries))
        assert P(*entries) == tuple(JP(*entries))


# --------------------------------------------------------------------- #
# Parallel.resolve_moe, ssm._pin, the production mesh
# --------------------------------------------------------------------- #


def _moe_cfgs():
    out = []
    for arch in ARCHS:
        if jcfgs.get_config(arch).n_experts:
            out.append((arch, False))
            out.append((arch, True))
    return out


@pytest.mark.parametrize("arch,slotted", _moe_cfgs())
def test_resolve_moe_matches_reference(arch, slotted):
    rep = {"moe_slotting": slotted}
    jcfg = dataclasses.replace(jcfgs.get_config(arch), **rep)
    tcfg = dataclasses.replace(tcfgs.get_config(arch), **rep)
    for model in (1, 4, 16):
        mesh = FakeMesh({"data": 2, "model": model})
        for mode in ("auto", "ep", "ep_rep", "local"):
            jpar = jmodel.Parallel(mesh=mesh, moe_mode=mode)
            tpar = tmodel.Parallel(mesh=mesh, moe_mode=mode)
            assert tpar.model_size == jpar.model_size == model
            for seq in (1, 32, 33):
                assert tpar.resolve_moe(tcfg, seq) == \
                    jpar.resolve_moe(jcfg, seq), (model, mode, seq)
    assert tmodel.Parallel().resolve_moe(tcfg, 32) == "local"


PIN_CASES = [((4, 32, 64), ("b", None, "m")), ((4, 32, 20), ("b", None, None)),
             ((4, 64, 16), ("b", "m", None)), ((3, 1, 64), ("b", None, "m")),
             ((32, 16, 4096), ("b", None, "m")), ((1, 8192, 33), ("b", "m", None))]


@pytest.mark.parametrize("mesh_shape", [{"data": 2, "model": 4},
                                        {"pod": 2, "data": 16, "model": 16},
                                        {"data": 4, "model": 1}])
def test_pin_spec_matches_reference(monkeypatch, mesh_shape):
    """``pin_spec`` is the spec the reference's ``_pin`` hands
    ``with_sharding_constraint``; the port's ``_pin`` returns the rank's
    block of that layout unchanged and refuses a tensor of another
    layout (the whole tensor, where the spec splits it)."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    mesh = FakeMesh(mesh_shape)
    axes = data_axes(mesh)
    jpar = jmodel.Parallel(mesh=mesh, data_axes=axes)
    tpar = tmodel.Parallel(mesh=mesh, data_axes=axes)
    for shape, dims in PIN_CASES:
        jssm._pin(jnp.zeros(shape), jpar, *dims)
        assert tssm.pin_spec(shape, tpar, *dims) == tuple(seen[-1])
        assert str(tssm.pin_spec(shape, tpar, *dims)) == str(seen[-1])
        spec = tssm.pin_spec(shape, tpar, *dims)
        block = [n // math.prod(mesh_shape[a] for a in
                                (e if isinstance(e, tuple) else (e,)))
                 if e is not None else n for n, e in zip(shape, spec)]
        x = torch.zeros(block)
        assert tssm._pin(x, tpar, shape, *dims) is x
        if block != list(shape):
            with pytest.raises(ValueError, match="the rank holds"):
                tssm._pin(torch.zeros(shape), tpar, shape, *dims)
    for par in (None, tmodel.Parallel()):
        assert tssm.pin_spec((4, 8), par, "b", "m") is None
        x = torch.zeros(4, 8)
        assert tssm._pin(x, par, (4, 8), "b", "m") is x


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_ranks(multi_pod, n):
    with pytest.raises(RuntimeError, match=f"needs {n} ranks, the process "
                                           "group has 1"):
        make_production_mesh(multi_pod=multi_pod, device="cpu")
