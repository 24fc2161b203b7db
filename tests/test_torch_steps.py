"""``launch.steps``: ``make_prefill_step`` and the meta-device stand-ins
(``param_structs``, ``opt_structs``, ``cache_structs``, ``input_specs``)
against the reference's ``jax.eval_shape`` structs, for every
(arch x shape) cell where ``shape_applies`` holds, as
``tests/test_launch.py`` lists the reference's.  Shapes and dtypes are
compared exactly; the port's layer j is the reference's
``units/b{j % len(pattern)}`` without the leading unit dim.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
import repro.launch.steps as jsteps
import repro.models as jmodels

import repro_torch.configs as tcfgs
import repro_torch.launch.steps as tsteps
import repro_torch.models as tmodels
from repro_torch.convert import params_from_jax
from repro_torch.tree import tree_leaves

CELLS = [(arch, shape) for arch in jcfgs.list_archs()
         for shape, spec in jcfgs.SHAPES.items()
         if jcfgs.shape_applies(jcfgs.get_config(arch), spec)[0]]


def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _walk(port, ref, width, path=(), stacked=False):
    """(path, port leaf, reference leaf, stacked) over the port's tree."""
    if isinstance(port, dict):
        assert set(port) == set(ref) - {"units"} | ({"layers"} if "units" in ref
                                                    else set()), path
        for k, v in port.items():
            if k == "layers":
                for j, layer in enumerate(v):
                    yield from _walk(layer, ref["units"][f"b{j % width}"],
                                     width, path + (k, j), True)
            else:
                yield from _walk(v, ref[k], width, path + (k,), stacked)
    else:
        yield path, port, ref, stacked


def _assert_same_structs(port, ref, cfg, what):
    width = len(cfg.pattern)
    n_units = jmodels.n_scan_units(cfg)
    pairs = list(_walk(port, ref, width))
    assert pairs, what
    for path, got, want, stacked in pairs:
        if want is None:
            assert got is None, (what, path)
            continue
        assert got.device.type == "meta", (what, path)
        shape = tuple(want.shape)
        if stacked:
            assert shape[0] == n_units, (what, path)
            shape = shape[1:]
        assert tuple(got.shape) == shape, (what, path)
        assert _dtype(got) == _dtype(want), (what, path)
    n_ref = sum(n_units if getattr(p[0], "key", None) == "units" else 1
                for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(pairs) == n_ref, what


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    spec = jcfgs.SHAPES[shape]
    want = jsteps.input_specs(jcfg, spec)
    got = tsteps.input_specs(tcfg, tcfgs.SHAPES[shape])
    assert set(got) == set(want)
    for key in want:
        if key == "opt_state":
            assert got[key]["count"].shape == () and \
                _dtype(got[key]["count"]) == _dtype(want[key]["count"])
            for moment in ("mu", "nu"):
                _assert_same_structs(got[key][moment], want[key][moment],
                                     jcfg, f"{arch} {shape} {moment}")
        elif isinstance(want[key], dict):
            _assert_same_structs(got[key], want[key], jcfg,
                                 f"{arch} {shape} {key}")
        elif want[key] is None:
            assert got[key] is None
        else:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(want[key].shape)
            assert _dtype(got[key]) == _dtype(want[key])
    flat = [x for x in tree_leaves(got) if x is not None]
    assert all(isinstance(x, torch.Tensor) and x.device.type == "meta"
               for x in flat)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-350m"])
def test_structs_match_reference(arch):
    """``param_structs``, ``opt_structs`` and ``cache_structs`` alone."""
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jp, tp = jsteps.param_structs(jcfg), tsteps.param_structs(tcfg)
    _assert_same_structs(tp, jp, jcfg, "params")
    jo, to = jsteps.opt_structs(jp), tsteps.opt_structs(tp)
    _assert_same_structs(to["mu"], jo["mu"], jcfg, "mu")
    _assert_same_structs(tsteps.cache_structs(tcfg, 2, 64),
                         jsteps.cache_structs(jcfg, 2, 64), jcfg, "cache")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b"])
def test_prefill_step_is_prefill(arch):
    cfg = tcfgs.smoke_config(arch)
    jc = jcfgs.smoke_config(arch)
    params = params_from_jax(cfg, jax.tree.map(
        np.asarray, jmodels.init_params(jc, jax.random.PRNGKey(0))), "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 7))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32)}
    step = tsteps.make_prefill_step(cfg, tmodels.Parallel(), max_len=12)
    got, got_cache = step(params, batch)
    want, want_cache = tmodels.prefill(cfg, params, batch, max_len=12)
    assert torch.equal(got, want)
    for a, b in zip(tree_leaves(got_cache), tree_leaves(want_cache)):
        assert torch.equal(a, b)
    jlog, _ = jsteps.make_prefill_step(jc, jmodels.Parallel(), 12)(
        jax.tree.map(jnp.asarray, jmodels.init_params(jc, jax.random.PRNGKey(0))),
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5)
