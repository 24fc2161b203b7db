"""Recurrent mixers: Mamba (selective SSM), mLSTM and sLSTM (xLSTM).

Counterpart of ``repro.models.ssm``.  All three expose the same entry
points:
  *_init(gen, cfg, dtype, device)               -> params
  *_forward(cfg, params, x, compute_dtype)      -> y          (prefill/forward)
  *_init_state / *_decode(...)                  -> O(1) decode state + step

The reference scans over time with ``lax.scan``; here the scan is a
Python loop over S that carries the decode state, so prefill and decode
run the same step and cannot drift apart.  These mixers carry no KV cache.
The loops iterate ``counting.steps``: a dry-run count runs the
first, one middle and the last step and multiplies the middle one.

Numerics are the reference's: ``softplus`` is ``logaddexp(x, 0)`` (not
``torch.nn.functional.softplus``, which switches to x above 20) and
log-sigmoid is ``-softplus(-x)``; the mLSTM ``m`` state starts at -1e30
and the sLSTM ``n`` state at 1e-6; the recurrences, the Mamba ``dt`` and
decay, mLSTM's gates and sLSTM's pre-activations and recurrent product
are f32 whatever the compute dtype (the f32 leaves ``a_log``,
``dt_bias``, ``w_gates``, ``b_gates``, ``r_h`` and ``b`` stay f32 under
``model.cast_for_compute``).

Tensor parallelism (``par`` with a model axis of M > 1 ranks, weights
held as the rank's blocks) follows the reference's ``_pin``: Mamba runs
by channel, the rank's block of ``d_inner`` (``w_in``'s x and z halves,
``conv_w``, ``conv_b``, ``d_skip``, ``dt_bias``, ``w_dt`` and ``a_log``
all on the rank's channels), ``w_x_proj`` and ``w_out`` by row, each
summed over the axis; its decode state is the rank's channels.  The
reference constrains the scan's inputs and carry to ``pin_spec``; here
``_pin`` checks that the rank holds exactly that layout's block.
mLSTM takes the rank's columns of q, k, v and z, gathers q, k and v
before the core (which every rank runs whole), and ``w_out`` by row.
sLSTM stays replicated, as the rules keep it.  ``mamba_*`` and
``mlstm_*`` take ``par`` as the reference's do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..distributed.collectives import (all_reduce, copy_to, gather_from,
                                      reduce_from, split_to)
from ..distributed.sharding import PartitionSpec
from ..counting import pad, steps
from .config import ModelConfig
from .layers import normal_init, out_proj_init


def pin_spec(shape, par, *dims) -> PartitionSpec | None:
    """The reference's ``_pin`` spec for a tensor of ``shape`` (None
    without a mesh).  dims entries: "b" batch axes, "m" model axis, None
    replicated, each divisibility-guarded."""
    if par is None or getattr(par, "mesh", None) is None:
        return None
    mesh = par.mesh
    n_data = math.prod(mesh.shape[a] for a in par.data_axes)
    n_model = mesh.shape[par.model_axis]
    baxes = par.data_axes if len(par.data_axes) > 1 else par.data_axes[0]
    spec = []
    for dim, want in zip(shape, dims):
        if want == "b" and n_data > 1 and dim % n_data == 0:
            spec.append(baxes)
        elif want == "m" and dim % n_model == 0 and n_model > 1:
            spec.append(par.model_axis)
        else:
            spec.append(None)
    return PartitionSpec(*spec)


def _pin(x: torch.Tensor, par, shape, *dims) -> torch.Tensor:
    """``x``, after checking that it is the rank's block of a global
    tensor of ``shape`` under ``pin_spec`` (module docstring): each dim
    the spec splits held split, the others whole.  Raises otherwise."""
    spec = pin_spec(shape, par, *dims)
    if spec is None:
        return x
    want = list(shape)
    for i, entry in enumerate(spec):
        if entry == par.model_axis:
            want[i] //= par.model_size
        elif entry is not None and par.dp:
            want[i] //= par.n_data
    if list(x.shape) != want:
        raise ValueError(f"_pin: the rank holds {tuple(x.shape)}, the block "
                         f"of {tuple(shape)} under {spec} is {tuple(want)}")
    return x


def _tp(cfg, par) -> bool:
    """Whether ``par`` splits the channels (``d_inner``) over its model axis."""
    return par is not None and getattr(par, "mesh", None) is not None \
        and par.split(cfg.d_inner)


def _global_rows(x: torch.Tensor, par) -> int:
    if par is None or getattr(par, "mesh", None) is None or not par.dp:
        return x.shape[0]
    return x.shape[0] * par.n_data


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), smooth everywhere."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return -softplus(-x)


# ===================================================================== #
# Mamba (selective state-space, Mamba-1)
# ===================================================================== #


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    n, r, dc = cfg.mamba_d_state, cfg.mamba_dt_rank, cfg.mamba_d_conv
    f32 = torch.float32
    # S4D-real initialization for A.
    a = torch.arange(1, n + 1, dtype=f32, device=device)[None, :].repeat(di, 1)
    return {
        "w_in": normal_init(gen, (d, 2 * di), dtype, device),
        "conv_w": normal_init(gen, (dc, di), dtype, device, scale=0.1),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_x_proj": normal_init(gen, (di, r + 2 * n), dtype, device),
        "w_dt": normal_init(gen, (r, di), dtype, device, scale=r ** -0.5),
        "dt_bias": torch.log(torch.expm1(
            torch.full((di,), 0.01, dtype=f32, device=device))),
        "a_log": torch.log(a),
        "d_skip": torch.ones((di,), dtype=f32, device=device),
        "w_out": out_proj_init(gen, (di, d), dtype, device, cfg.n_layers),
    }


def _mamba_scan_step(a_neg, carry, xt, dt, b_t, c_t):
    """One SSM step.  carry h: (B, di, N); xt/dt: (B, di); b/c: (B, N)."""
    da = torch.exp(dt[..., None] * a_neg[None])               # (B, di, N)
    dbx = dt[..., None] * b_t[:, None, :] * xt[..., None]     # (B, di, N)
    h = da * carry + dbx
    y = torch.einsum("bdn,bn->bd", h, c_t)
    return h, y


def _mamba_inner(cfg, params, xz, conv_state, ssm_state, compute_dtype,
                 par=None):
    """Shared conv+SSM core.  xz: (B, S, 2*di).  States carried across calls.

    conv_state: (B, dc-1, di) trailing inputs; ssm_state: (B, di, N).
    Returns (y (B,S,di), new_conv_state, new_ssm_state).
    """
    n = cfg.mamba_d_state
    x, z = torch.chunk(xz, 2, dim=-1)                          # (B, S, di)
    s = x.shape[1]
    dc = cfg.mamba_d_conv
    tp = _tp(cfg, par)
    bg, di = _global_rows(x, par), cfg.d_inner

    # Causal depthwise conv along S with carried state, taps summed in the
    # reference's order.
    xpad = torch.cat([conv_state.to(x.dtype), x], dim=1)
    conv_w = params["conv_w"].to(x.dtype)                     # (dc, di)
    xc = sum(xpad[:, i:i + s, :] * conv_w[i] for i in range(dc))
    xc = F.silu(xc + params["conv_b"].to(x.dtype))
    new_conv_state = xpad[:, s:, :] if dc > 1 else conv_state
    xc = _pin(xc, par, (bg, s, di), "b", None, "m")

    proj = xc @ params["w_x_proj"].to(x.dtype)                # (B,S,r+2N)
    if tp:
        # Summed over the channels' ranks; every rank then reads all of
        # it for its own channels, so its grad is summed over them too.
        proj = all_reduce(proj, par.model_group())
    r = cfg.mamba_dt_rank
    dt_r, b_ssm, c_ssm = torch.split(proj, [r, n, n], dim=-1)
    b_ssm = _pin(b_ssm, par, (bg, s, n), "b", None, None)
    c_ssm = _pin(c_ssm, par, (bg, s, n), "b", None, None)
    dt = softplus((dt_r @ params["w_dt"].to(x.dtype)).float()
                  + params["dt_bias"])                        # (B,S,di) f32
    dt = _pin(dt, par, (bg, s, di), "b", None, "m")
    ssm_state = _pin(ssm_state, par, (bg, di, n), "b", "m", None)
    a_neg = -torch.exp(params["a_log"])                       # (di, N)

    h = ssm_state
    ys = []
    for t in steps(s):
        h, y = _mamba_scan_step(a_neg, h, xc[:, t].float(), dt[:, t],
                                b_ssm[:, t].float(), c_ssm[:, t].float())
        ys.append(y)
    y = torch.stack(pad(ys, s), dim=1).to(compute_dtype)      # (B,S,di)
    y = y + xc * params["d_skip"].to(compute_dtype)
    y = y * F.silu(z)
    return y, new_conv_state.float(), h


def _mamba_in(cfg, params, x, compute_dtype, par):
    """(B, S, 2 di) of the rank's channels: its x block, then its z block."""
    x = x.to(compute_dtype)
    if _tp(cfg, par):
        x = copy_to(x, par.model_group())
    return x @ params["w_in"].to(compute_dtype)


def _mamba_out(cfg, params, y, compute_dtype, par):
    y = y @ params["w_out"].to(compute_dtype)
    return reduce_from(y, par.model_group()) if _tp(cfg, par) else y


def mamba_forward(cfg, params, x, compute_dtype, par=None):
    st = mamba_init_state(cfg, x.shape[0], x.device,
                          params["conv_b"].shape[0])
    xz = _mamba_in(cfg, params, x, compute_dtype, par)
    y, _, _ = _mamba_inner(cfg, params, xz, st["conv"], st["ssm"],
                           compute_dtype, par)
    return _mamba_out(cfg, params, y, compute_dtype, par)


def mamba_init_state(cfg: ModelConfig, batch: int, device="cuda",
                     channels: int = 0) -> dict:
    """Zero state of ``channels`` channels (``d_inner`` by default)."""
    dev = resolve_device(device)
    di = channels or cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di),
                            dtype=torch.float32, device=dev),
        "ssm": torch.zeros((batch, di, cfg.mamba_d_state),
                           dtype=torch.float32, device=dev),
    }


def mamba_decode(cfg, params, x, state, compute_dtype, par=None):
    """x: (B, S, d) -> (y (B,S,d), new state); S = 1 in decode."""
    xz = _mamba_in(cfg, params, x, compute_dtype, par)
    y, conv, ssm = _mamba_inner(cfg, params, xz, state["conv"], state["ssm"],
                                compute_dtype, par)
    return _mamba_out(cfg, params, y, compute_dtype, par), \
        {"conv": conv, "ssm": ssm}


# ===================================================================== #
# mLSTM (xLSTM matrix-memory block)
# ===================================================================== #


def mlstm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    """Separate q/k/v projections, as the reference (which shards the
    matrix memory by rows under tensor parallelism)."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    f32 = torch.float32
    return {
        "w_q_m": normal_init(gen, (d, di), dtype, device),
        "w_k_m": normal_init(gen, (d, di), dtype, device),
        "w_v_m": normal_init(gen, (d, di), dtype, device),
        "w_gates": normal_init(gen, (d, 2 * nh), f32, device),
        # forget-gate bias init high (remember by default)
        "b_gates": torch.cat([torch.zeros((nh,), dtype=f32, device=device),
                              torch.full((nh,), 3.0, dtype=f32,
                                         device=device)]),
        "w_z": normal_init(gen, (d, di), dtype, device),
        "w_out": out_proj_init(gen, (di, d), dtype, device, cfg.n_layers),
    }


def mlstm_init_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    dev = resolve_device(device)
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    f32 = torch.float32
    return {
        "c": torch.zeros((batch, nh, dh, dh), dtype=f32, device=dev),
        "n": torch.zeros((batch, nh, dh), dtype=f32, device=dev),
        "m": torch.full((batch, nh), -1e30, dtype=f32, device=dev),
    }


def _mlstm_memory(c, n, f_g, i_g, k, v):
    """The state update: C = f C + i (v k^T) (row = v index), n = f n + i k."""
    c = f_g[..., None, None] * c + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    return c, n


def _mlstm_step(carry, inp):
    """Stabilized exponential-gating matrix-memory update."""
    c, n, m = carry
    q, k, v, log_i, log_f = inp        # q/k/v: (B,NH,dh); gates: (B,NH)
    m_new = torch.maximum(log_f + m, log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c, n = _mlstm_memory(c, n, f_g, i_g, k, v)
    num = torch.einsum("bhij,bhj->bhi", c, q)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n, q)), min=1.0)
    h = num / den[..., None]
    return (c, n, m_new), h


def _mlstm_core(cfg, params, x, state, compute_dtype, par=None):
    b, s, _ = x.shape
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    xq = x.to(compute_dtype)
    tp = _tp(cfg, par)
    xf = copy_to(xq, par.model_group()) if tp else xq
    q = xf @ params["w_q_m"].to(compute_dtype)
    k = xf @ params["w_k_m"].to(compute_dtype)
    v = xf @ params["w_v_m"].to(compute_dtype)
    if tp:
        q, k, v = (gather_from(t, -1, par.model_group()) for t in (q, k, v))
    scale = dh ** -0.5
    q = q.reshape(b, s, nh, dh).float()
    k = (k.reshape(b, s, nh, dh) * scale).float()
    v = v.reshape(b, s, nh, dh).float()
    gates = xq.float() @ params["w_gates"] + params["b_gates"]
    log_i, f_raw = torch.chunk(gates, 2, dim=-1)              # (B,S,NH)
    log_f = _log_sigmoid(f_raw)

    carry = (state["c"], state["n"], state["m"])
    hs = []
    for t in steps(s):
        carry, h = _mlstm_step(carry, (q[:, t], k[:, t], v[:, t],
                                       log_i[:, t], log_f[:, t]))
        hs.append(h)
    c, n, m = carry
    h = torch.stack(pad(hs, s), dim=1).reshape(b, s, cfg.d_inner).to(compute_dtype)
    z = F.silu(xf @ params["w_z"].to(compute_dtype))
    if tp:
        h = split_to(h, -1, par.model_group())     # the rank's z columns
    y = (h * z) @ params["w_out"].to(compute_dtype)
    if tp:
        y = reduce_from(y, par.model_group())
    return y, {"c": c, "n": n, "m": m}


def mlstm_forward(cfg, params, x, compute_dtype, par=None):
    y, _ = _mlstm_core(cfg, params, x,
                       mlstm_init_state(cfg, x.shape[0], x.device),
                       compute_dtype, par)
    return y


def mlstm_decode(cfg, params, x, state, compute_dtype, par=None):
    return _mlstm_core(cfg, params, x, state, compute_dtype, par)


# ===================================================================== #
# sLSTM (xLSTM scalar-memory block with per-head recurrence)
# ===================================================================== #


def slstm_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> dict:
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.n_heads
    dh = di // nh
    f32 = torch.float32

    def full(size, value):
        return torch.full((size,), value, dtype=f32, device=device)
    return {
        "w_x": normal_init(gen, (d, 4 * di), dtype, device),
        # block-diagonal recurrent weights, one (dh, 4*dh) block per head
        "r_h": normal_init(gen, (nh, dh, 4 * dh), f32, device,
                           scale=dh ** -0.5),
        # (z, i, f, o) biases; forget bias high
        "b": torch.cat([full(2 * di, 0.0), full(di, 3.0), full(di, 0.0)]),
        "w_out": out_proj_init(gen, (di, d), dtype, device, cfg.n_layers),
    }


def slstm_init_state(cfg: ModelConfig, batch: int, device="cuda") -> dict:
    dev = resolve_device(device)
    nh = cfg.n_heads
    dh = cfg.d_inner // nh
    z = torch.zeros((batch, nh, dh), dtype=torch.float32, device=dev)
    return {"c": z, "n": z + 1e-6, "h": z.clone(),
            "m": torch.full((batch, nh, dh), -1e30, dtype=torch.float32,
                            device=dev)}


def _slstm_step(params_rh, carry, x_gates):
    """x_gates: (B, 4*di) pre-activations from the input path."""
    c, n, h, m = carry                 # each (B, NH, dh)
    b, nh, dh = c.shape
    rec = torch.einsum("bhd,hdk->bhk", h, params_rh)          # (B,NH,4dh)
    pre = x_gates.reshape(b, nh, 4 * dh) + rec
    z_p, i_p, f_p, o_p = torch.chunk(pre, 4, dim=-1)
    log_i = i_p
    log_f = _log_sigmoid(f_p)
    m_new = torch.maximum(log_f + m, log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + m - m_new)
    z_v = torch.tanh(z_p)
    c_new = f_g * c + i_g * z_v
    n_new = f_g * n + i_g
    h_new = torch.sigmoid(o_p) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_core(cfg, params, x, state, compute_dtype):
    b, s, _ = x.shape
    pre = (x.to(compute_dtype) @ params["w_x"].to(compute_dtype)
           ).float() + params["b"]                           # (B,S,4di)
    carry = (state["c"], state["n"], state["h"], state["m"])
    hs = []
    for t in steps(s):
        carry, h = _slstm_step(params["r_h"], carry, pre[:, t])
        hs.append(h)
    c, n, h, m = carry
    y = torch.stack(pad(hs, s), dim=1).reshape(b, s, cfg.d_inner).to(compute_dtype)
    y = y @ params["w_out"].to(compute_dtype)
    return y, {"c": c, "n": n, "h": h, "m": m}


def slstm_forward(cfg, params, x, compute_dtype):
    y, _ = _slstm_core(cfg, params, x,
                       slstm_init_state(cfg, x.shape[0], x.device),
                       compute_dtype)
    return y


def slstm_decode(cfg, params, x, state, compute_dtype):
    return _slstm_core(cfg, params, x, state, compute_dtype)
