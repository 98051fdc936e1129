"""Dropout ops, including layout-consistent sparse-input dropout.

The reference drops nonzero entries of the sparse BoW input
(``gcnmodel.py :: SparseInputDropoutLayer``). The SpMM keeps both X and Xᵀ
in bucketed layout (the transpose drives the backward pass), so the dropout
mask must agree between the two layouts entry for entry. The mask is
therefore derived from a *position-keyed integer hash* of each entry's
global id ``row * n_cols + col`` — identical no matter which layout
enumerates the entry — rather than from shaped random draws.

The hash is bit-exact with ``graphconvgeo_tpu/ops/dropout.py``: the same
ids and integer seeds give the same masks. It runs on int64 tensors masked
to 32 bits after every multiply and xor (PyTorch's CPU build has no right
shift for uint32), which reproduces the uint32 wrap-around exactly.
"""

from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF


def _wang_hash(x):
    """Wang integer hash of uint32 values held in an int64 tensor (or of
    one in a Python int)."""
    x = x & _M32
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    x = x ^ (x >> 15)
    return x


def _seed_hash(seed: int) -> int:
    """The seed's hash, computed on the host: a tensor made from it on the
    card would be a blocking copy, which waits for the card's queue to
    drain, once for every masked operand of a step."""
    return _wang_hash(int(seed) & _M32)


def entry_uniform(entry_id: torch.Tensor, seed: int) -> torch.Tensor:
    """Uniform [0,1) float32 per entry id (uint32-wrapped), keyed by an
    integer seed."""
    h = _wang_hash((entry_id.to(torch.int64) & _M32) ^ _seed_hash(seed))
    return h.to(torch.float32) / float(2**32)


def entry_keep(entry_id: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """Boolean keep mask per entry id (True with probability ``1 - rate``):
    the top 31 hash bits compared against ``rate·2³¹``."""
    h = _wang_hash((entry_id.to(torch.int64) & _M32) ^ _seed_hash(seed))
    thr = min(int(rate * (1 << 31)), (1 << 31) - 1)
    return (h >> 1) >= thr


def ell_dropout_values(
    indices: torch.Tensor,
    values: torch.Tensor,
    *,
    rate: float,
    seed: int,
    n_cols: int,
    transposed: bool,
    row_offset: int = 0,
) -> torch.Tensor:
    """Dropout over ELL values with an entry-position-keyed mask.

    For the forward layout, entry (i, k) has global id
    ``(i + row_offset) * n_cols + indices[i, k]``; for the transposed layout
    the same logical entry sits at row j = its column, so its id is
    ``(indices[j, k] + row_offset) * n_cols + j``: both enumerate one id
    set, hence one mask. ``row_offset`` shifts the row-dimension ids (a
    rank's local block of a globally numbered matrix). The JAX package
    computes the id in int32, which wraps once it passes 2³¹; the hash
    keeps the low 32 bits of the int64 id, the same bits."""
    if rate <= 0.0:
        return values
    n, k = indices.shape
    row_ids = torch.arange(n, dtype=torch.int64, device=indices.device)[:, None]
    idx = indices.to(torch.int64)
    if transposed:
        entry_id = (idx + row_offset) * n_cols + row_ids
    else:
        entry_id = (row_ids + row_offset) * n_cols + idx
    keep = (entry_uniform(entry_id, seed) >= rate).to(values.dtype)
    return values * keep / (1.0 - rate)


def bell_dropout(bell, *, rate: float, seed: int, n_cols_forward: int, transposed: bool):
    """Entry-position-keyed dropout over a :class:`BucketedEll`'s values.

    ``n_cols_forward`` is always the FORWARD matrix's column count (vocab
    size for the BoW input), so the forward and transposed layouts enumerate
    identical entry-id sets and thus identical masks."""
    if rate <= 0.0:
        return bell
    new_vals = []
    for idx, val, rid in zip(bell.indices, bell.values, bell.row_ids):
        rid_col = rid[:, None].to(torch.int64)
        idx = idx.to(torch.int64)
        if transposed:
            # rows are forward-cols j (= rid), entries are forward-rows i (= idx)
            entry_id = idx * n_cols_forward + rid_col
        else:
            entry_id = rid_col * n_cols_forward + idx
        u = entry_uniform(entry_id, seed)
        new_vals.append(val * (u >= rate).to(val.dtype) / (1.0 - rate))
    return dataclasses.replace(bell, values=tuple(new_vals))


def slab_dropout(
    slab: torch.Tensor,
    cols: torch.Tensor,
    *,
    rate: float,
    seed: int,
    n_cols: int,
    row_offset: int = 0,
) -> torch.Tensor:
    """Entry-position-keyed dropout over a dense head slab.

    Entry (i, j) of the slab is global entry (i, cols[j]) of X, so its id is
    ``i * n_cols + cols[j]`` — the same keying as :func:`bell_dropout`, hence
    a slab-backed input layer drops the IDENTICAL entry set as the bell path
    for the same seed (zero entries are scaled too, which is a no-op)."""
    if rate <= 0.0:
        return slab
    n = slab.shape[0]
    row_ids = torch.arange(n, dtype=torch.int64, device=slab.device)[:, None] + row_offset
    entry_id = row_ids * n_cols + cols[None, :].to(torch.int64)
    u = entry_uniform(entry_id, seed)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=slab.dtype))
    return slab * (u >= rate).to(slab.dtype) * scale


def dropout(x: torch.Tensor, *, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Standard inverted dropout (reference: ``lasagne.layers.DropoutLayer``),
    drawn from ``generator`` (which lives on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))
