# Copied from passl_tpu/models/utils/pos_embed.py; the port keeps its own copy and imports nothing of passl_tpu.
# Unchanged: the file imports only numpy.
"""2D sin-cos position embeddings.

Capability parity with reference `passl/models/utils/pos_embed.py`
(get_2d_sincos_pos_embed used by MAE) and the MoCo v3 variant built
inline in `models/mocov3.py:67-91` (meshgrid w/h ordering with
[sin w, cos w, sin h, cos h] concat). Both reproduce the torch
reference implementations bit-for-bit in layout.
"""
from __future__ import annotations

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed_from_grid(embed_dim: int, grid: np.ndarray) -> np.ndarray:
    assert embed_dim % 2 == 0
    emb_h = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[0])
    emb_w = get_1d_sincos_pos_embed_from_grid(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """MAE-style [gs*gs(+1), D] float32 (reference pos_embed.py)."""
    grid_h = np.arange(grid_size, dtype=np.float64)
    grid_w = np.arange(grid_size, dtype=np.float64)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    pos_embed = get_2d_sincos_pos_embed_from_grid(embed_dim, grid)
    if cls_token:
        pos_embed = np.concatenate([np.zeros((1, embed_dim)), pos_embed], axis=0)
    return pos_embed.astype(np.float32)


def mocov3_2d_sincos_pos_embed(embed_dim: int, h: int, w: int, temperature: float = 10000.0) -> np.ndarray:
    """MoCo v3-style [1, h*w+1, D] with zero cls slot (reference
    mocov3.py build_2d_sincos_position_embedding)."""
    assert embed_dim % 4 == 0
    grid_w, grid_h = np.meshgrid(np.arange(w, dtype=np.float64),
                                 np.arange(h, dtype=np.float64), indexing="ij")
    pos_dim = embed_dim // 4
    omega = np.arange(pos_dim, dtype=np.float64) / pos_dim
    omega = 1.0 / temperature**omega
    out_w = grid_w.reshape(-1)[:, None] @ omega[None]
    out_h = grid_h.reshape(-1)[:, None] @ omega[None]
    pos = np.concatenate([np.sin(out_w), np.cos(out_w), np.sin(out_h), np.cos(out_h)], axis=1)[None]
    cls = np.zeros((1, 1, embed_dim))
    return np.concatenate([cls, pos], axis=1).astype(np.float32)
