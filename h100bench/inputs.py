"""What a run feeds the program and the reference, made from ``--seed``
by the benchmark itself: the weights, in the port's parameter layout, and
the token batches of a traffic mix.

Each weight (a leaf) and each batch is drawn by its own generator, seeded
from (seed, what, index) through ``numpy.random.SeedSequence``, so any one
of them can be drawn again alone, on any device, and equals the first
draw.  The weights are drawn on the device in f32 and stored in the type
they are used in: bf16 for serving (the router and the norm scales stay
f32, as the port keeps them), f32 master weights for training.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .yardstick import Sizes

WEIGHTS, BATCHES, CALIBRATION = 1, 2, 3


def derived_seed(seed: int, *what: int) -> int:
    """A 63-bit seed for (seed, *what); ``seed`` may be any whole number."""
    words = [int(seed) & (2**64 - 1), int(seed) >> 64 & (2**64 - 1), *what]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def leaf_specs(s: Sizes):
    """(path, shape, std, kind) of every weight, in draw order; ``kind`` is
    "norm" for a norm scale (drawn around 1), "router" for the f32
    router, "w" for the rest."""
    d = s.d_model
    std = d ** -0.5                    # 0.022 (deepseek), 0.026 (granite)
    out_std = std / math.sqrt(2 * s.n_layers)
    specs = [(("embed",), (s.padded_vocab, d), std, "w"),
             (("final_norm", "scale"), (d,), 0.1, "norm")]
    if not s.tie_embeddings:
        specs.append((("head",), (d, s.padded_vocab), std, "w"))

    def block(prefix, ffn):
        specs.extend([
            (prefix + ("norm1", "scale"), (d,), 0.1, "norm"),
            (prefix + ("mixer", "w_q"), (d, s.q_dim), std, "w"),
            (prefix + ("mixer", "w_k"), (d, s.kv_dim), std, "w"),
            (prefix + ("mixer", "w_v"), (d, s.kv_dim), std, "w"),
            (prefix + ("mixer", "w_o"), (s.q_dim, d), out_std, "w"),
            (prefix + ("norm2", "scale"), (d,), 0.1, "norm")])
        specs.extend((prefix + ("ffn",) + p, shape, std, kind)
                     for p, shape, std, kind in ffn)

    def swiglu(prefix, width):
        return [(prefix + ("w_gate",), (d, width), std, "w"),
                (prefix + ("w_up",), (d, width), std, "w"),
                (prefix + ("w_down",), (width, d), out_std, "w")]

    if s.first_dense_d_ff:
        block(("first",), swiglu((), s.first_dense_d_ff))
    e, f = s.n_experts, s.d_expert
    moe = [(("router",), (d, e), std, "router"),
           (("w_gate",), (e, d, f), std, "w"),
           (("w_up",), (e, d, f), std, "w"),
           (("w_down",), (e, f, d), out_std, "w")]
    if s.n_shared:
        moe += swiglu(("shared",), f * s.n_shared)
    for i in range(s.n_moe_layers):
        block(("layers", i), moe)
    return specs


def draw_leaf(spec, index: int, seed: int, device, train: bool) -> torch.Tensor:
    """Leaf ``index`` of ``leaf_specs``, drawn as ``draw_weights`` draws it."""
    _, shape, std, kind = spec
    gen = generator(device, derived_seed(seed, WEIGHTS, index))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    w.mul_(std)
    if kind == "norm":
        w.add_(1.0)
    if train or kind != "w":
        return w
    return w.to(torch.bfloat16)


def draw_weights(s: Sizes, seed: int, device, train: bool = False) -> dict:
    """The whole model in the port's parameter tree (``params["layers"]``
    a list of per-layer dicts, ``params["first"]`` the dense first
    block)."""
    params: dict = {}
    for i, spec in enumerate(leaf_specs(s)):
        path, node = spec[0], params
        for key in path[:-1]:
            if key == "layers":
                node = node.setdefault(key, [])
            elif isinstance(key, int):
                if len(node) == key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = draw_leaf(spec, i, seed, device, train)
    return params


def leaf_at(params: dict, path):
    node = params
    for key in path:
        node = node[key]
    return node


def tokens(seed: int, what: int, index: int, shape, vocab: int,
           device) -> torch.Tensor:
    """Token ids uniform over [0, vocab), int32, for batch ``index``."""
    gen = generator(device, derived_seed(seed, what, index))
    return torch.randint(0, vocab, shape, generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)
