"""Error-feedback int8 gradient compression (port of
`repro.optim.compression`).

Gradients are quantized to int8 with a per-tile fp32 scale (tiles of
`TILE` elements over the flattened leaf) and the quantization error is
carried to the next step.  The reference returns new trees; here
`compress_decompress` writes the dequantized grads and the new error into
the trees it was given.  `torch.round` and `jnp.round` both round half to
even, so the bits are the reference's on the same fp32 inputs.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..core import tree as T

__all__ = ["init_error_state", "compress_decompress", "TILE"]

TILE = 256
#: tiles quantized together (bounds the temporaries to 64 MB of fp32)
_ROWS = 1 << 16


def init_error_state(params: Any) -> Any:
    return T.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def _roundtrip_(g: torch.Tensor, e: torch.Tensor) -> None:
    """One group of whole tiles, (rows, TILE) views: e := g + e (the
    target), g := Q(target) dequantized, e := target - that."""
    e.add_(g.float())
    scale = e.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(e / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    deq = q.float() * scale
    g.copy_(deq)
    e.sub_(deq)


def compress_decompress(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Error-feedback int8 round trip, in place: g_hat = Q(g + e) into the
    grads, e' = (g + e) - g_hat into the error.  Returns (grads, err)."""
    for g, e in zip(T.leaves(grads), T.leaves(err)):
        if not (g.is_contiguous() and e.is_contiguous()):
            raise ValueError("compression: leaves must be contiguous")
        g, e = g.view(-1), e.view(-1)
        full = g.numel() - g.numel() % TILE
        for a in range(0, full, _ROWS * TILE):
            b = min(full, a + _ROWS * TILE)
            _roundtrip_(g[a:b].view(-1, TILE), e[a:b].view(-1, TILE))
        if full < g.numel():
            # the last, partial tile: the reference pads it with zeros,
            # which change neither its max nor its kept elements
            _roundtrip_(g[full:].view(1, -1), e[full:].view(1, -1))
    return grads, err
