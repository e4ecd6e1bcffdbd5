"""Weights from the seed, made on the device in a few large draws.

One state dict, keyed by the names that the port's modules and the plain
reference share, is made once for the program and once again, from the
same seed, for the reference: neither side takes the other's tensors.

Rules by leaf (the benchmark's own, not the port's `init_weights`):
* a bias, a LayerNorm shift, a frozen BatchNorm's shift and mean: zeros,
* a LayerNorm scale, a frozen BatchNorm's scale and variance: ones,
* a convolution kernel [O, I, k, k]: normal, std 1/sqrt(I*k*k),
* every other weight (dense, embedding, per-head projection): normal,
  std `std`.
All normals come from one `torch.randn` on the device; the leaves are
views scaled from it, in the order of the names given.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

ZERO_SUFFIXES = (".bias", ".running_mean", "out_bias")
ONE_SUFFIXES = (".running_var",)


def leaf_rule(name: str, shape: Tuple[int, ...], std: float,
              norm_modules: Iterable[str]) -> Tuple[str, float]:
    """("zeros" | "ones" | "normal", std) of one leaf.  `norm_modules` are
    the module prefixes of LayerNorms and BatchNorms (their `weight` is a
    scale)."""
    module = name.rsplit(".", 1)[0]
    if name.endswith(ZERO_SUFFIXES):
        return "zeros", 0.0
    if name.endswith(ONE_SUFFIXES) or (name.endswith(".weight") and module in norm_modules):
        return "ones", 0.0
    if len(shape) == 4:
        return "normal", 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
    return "normal", std


def seeded_state(shapes: Dict[str, Tuple[int, ...]], norm_modules: Iterable[str],
                 seed: int, device, std: float = 0.02) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor on `device`} for the named shapes, from `seed`."""
    norm_modules = set(norm_modules)
    rules = {n: leaf_rule(n, s, std, norm_modules) for n, s in shapes.items()}
    total = sum(math.prod(shapes[n]) for n, (kind, _) in rules.items() if kind == "normal")
    g = torch.Generator(torch.device(device)).manual_seed(int(seed) % 2 ** 63)
    flat = torch.randn(total, generator=g, device=device)
    out, at = {}, 0
    for name, (kind, s) in rules.items():
        shape = tuple(shapes[name])
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            n = math.prod(shape)
            out[name] = flat[at:at + n].view(shape).mul_(s)
            at += n
    return out


def shapes_of(module: torch.nn.Module) -> Tuple[Dict[str, Tuple[int, ...]], set]:
    """The state dict's (name -> shape) of a module, each tied tensor once
    under its first name, and the prefixes of its normalization modules
    (any module whose class name holds "Norm" or "BN")."""
    seen, shapes = set(), {}
    for name, t in module.state_dict(keep_vars=True).items():
        if id(t) in seen:
            continue
        seen.add(id(t))
        shapes[name] = tuple(t.shape)
    norms = {n for n, m in module.named_modules()
             if "Norm" in type(m).__name__ or "BN" in type(m).__name__}
    return shapes, norms
