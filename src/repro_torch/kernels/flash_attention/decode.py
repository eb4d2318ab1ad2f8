"""Decode attention: one query token per slot against its KV cache.

The serving hot path. Every decode step attends a single query token per
slot to that slot's ring-buffer cache. Two versions of the same function:

  `decode_attention_fwd` — the launch wrapper of `csrc/decode_attention.cu`,
      the Hopper kernel that replaces the TPU kernel
      `repro/kernels/flash_attention/decode.py::decode_attention_fwd`. It is
      bound by the bytes of the keys that count, so it reads only those:
      each block flags the 32-key tiles of its slot that hold a valid key
      (one `__ballot_sync` a tile over the positions) and visits those
      alone, which is exact because a masked score's exp is 0 once the row
      max is real. A row with no valid key (a slot never used) gets the
      plain version's answer, the mean of its W values, from V alone: all
      its tiles, no K read. Each (slot, kv head) is split `decode_splits`
      ways over its tiles (balanced in rank order), the splits' partial
      softmax states go to a workspace and a second small kernel merges
      them; K/V tiles are double-buffered with `cp.async` straight from
      the model's (B, W, Hkv, Dh) layout through strides, and each tile is
      read once for the whole GQA group. See the note in the source.
  `grouped_decode` — the plain version (the counterpart of `_xla_decode`):
      the (B, W, Hkv) cache contracted against (B, Hkv, G) query rows with
      no materialized head repeat.

The paged variant reads a slot's keys out of a shared PAGE POOL through
its block table instead of a per-slot cache:

  `paged_decode_attention_fwd` — the launch wrapper of
      `csrc/paged_decode_attention.cu`, the Hopper kernel that replaces the
      TPU kernel `repro/kernels/flash_attention/decode.py::
      paged_decode_attention_fwd`. It is bound by the bytes of the keys
      that count, so it reads only those: each block flags the 32-key
      tiles of its slot that hold a valid key (positions read through the
      table, one `__ballot_sync` a tile) and visits those alone, which is
      exact because a masked score's exp is 0 once the row max is real. A
      row with no valid key at all walks every tile, as the plain version
      does, and gets its mean of every value. Each (slot, kv head) is split
      `decode_splits` ways over its VALID tiles (balanced in rank order, not
      by width; enough splits to fill every SM with the blocks its shared
      memory holds: `decode_blocks_per_sm`), and the splits are merged as
      in the slot-cache kernel (the two share `csrc/decode_common.cuh`);
      K/V tiles are double-buffered with
      `cp.async` straight from the pool's (P, page, Hkv, Dh) layout
      through strides, with no gathered copy.
  `paged_gather_decode` — the plain version (the JAX package's XLA path,
      `decode.py:356-366`): gather `pool[block_tables]` into the dense
      per-slot view, then `grouped_decode`. With nb * page == W it is
      `decode_attention` on the gathered caches, which makes the paged
      engine provably equal to the dense one.

Both kernels take head dims up to 256 and GQA groups up to 16 (one
instantiation a shape: `decode_shape`). Both read q in f32, bf16 or f16 and
the cache or pool in f32, bf16 or f16, independently (the engines hold f32
caches under bf16 activations), and write the output in q's dtype, as the
TPU kernels do; each tensor's strides are in its own elements.

`decode_attention` and `paged_decode_attention` pick by device: the plain
version for CPU tensors, the kernel for CUDA tensors. Masking is wholly
data-driven (kv validity + position vs the slot's query position), so
ragged per-slot lengths, ring-buffer layouts and unallocated pages (the
NULL page's positions are -1) need no host-side bookkeeping.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import dtype_code, on_cuda, refuse_grad
from repro_torch.kernels.build import check, current_stream, library
from repro_torch.kernels.flash_attention.kernel import (
    BLOCK_RESERVED_BYTES, D_MAX, SM_SHARED_BYTES, TILE_KEYS, sm_count)

MASK_VALUE = -2.0 ** 30
MAX_GROUP = 16   # csrc/decode_common.cuh: kDecodeMaxGroup
MAX_SPLITS = 8   # csrc/decode_common.cuh: kMaxSplits
# blocks of a decode kernel an SM should get at most: at head dims up to
# 128 and groups up to 8 its shared memory (72.7 KB a block) lets three
# stay resident, and filling all three measured faster than two
# (chip_smoke.py phase 3 times each split count; PERF.md)
BLOCKS_PER_SM = 3


def decode_shape(Dh: int, Dv: int, G: int):
    """The instantiation (kD, kR) of csrc/decode_common.cuh's DecodeShape
    that the decode kernels launch for these widths and this GQA group:
    kD 128 up to 128, else 256; kR 2 query rows a warp up to G 8, else 4."""
    return (128 if max(Dh, Dv) <= 128 else 256), (2 if G <= 8 else 4)


def decode_block_bytes(Dh: int, Dv: int, G: int) -> int:
    """Dynamic shared memory of a decode block of that instantiation, past
    its per-tile lists (DecodeShape::kFixedSmem: 4 kR query rows and
    weight rows of kD + 32 floats, two stages of K and of V tiles of 32
    rows of kD + 4)."""
    kd, kr = decode_shape(Dh, Dv, G)
    return (4 * kr * (kd + TILE_KEYS) + 4 * TILE_KEYS * (kd + 4)) * 4


def decode_blocks_per_sm(Dh: int, Dv: int, G: int) -> int:
    """Blocks of the decode kernels' instantiation for (Dh, Dv, G) that
    stay resident on an SM by its shared memory, at most BLOCKS_PER_SM: 3
    at (128, 2), 2 at (128, 4), 1 at (256, 2) and (256, 4)."""
    per = decode_block_bytes(Dh, Dv, G) + BLOCK_RESERVED_BYTES
    return max(1, min(BLOCKS_PER_SM, SM_SHARED_BYTES // per))


def decode_splits(B: int, Hkv: int, width: int, sms: int,
                  blocks_per_sm: int = BLOCKS_PER_SM) -> int:
    """Splits S of each (slot, kv head) row of `width` keys in the two
    decode kernels: the smallest S that puts `blocks_per_sm` blocks (the
    launched instantiation's, `decode_blocks_per_sm`) on every SM
    (B * Hkv * S >= blocks_per_sm * sms), at most MAX_SPLITS and at most
    the row's tile count. A function of shapes alone, so choosing it needs
    no device sync."""
    cap = max(1, min(MAX_SPLITS, -(-width // TILE_KEYS)))
    return max(1, min(cap, -(-blocks_per_sm * sms // max(B * Hkv, 1))))


def decode_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         q_positions: torch.Tensor,
                         kv_positions: torch.Tensor, *, scale: float,
                         sliding_window: Optional[int],
                         softcap: Optional[float]) -> torch.Tensor:
    """q (B, 1, Hq, Dh), k (B, W, Hkv, Dh), v (B, W, Hkv, Dv) CUDA with
    unit stride on head_dim, q f32, bf16 or f16, k and v one dtype, f32 or
    bf16; q_positions (B,) and kv_positions (B, W) int32 on the same
    device. Returns (B, 1, Hq, Dv) in q's dtype."""
    refuse_grad("decode_attention_fwd", q, k, v)
    q_code = dtype_code("decode_attention_fwd: q", q.dtype)
    kv_code = dtype_code("decode_attention_fwd: k", k.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dim() != 4:
            raise ValueError(f"decode_attention_fwd: {name} must be a 4-D "
                             f"CUDA tensor, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"decode_attention_fwd: {name} needs unit "
                             f"stride on head_dim")
    B, Sq, Hq, Dh = q.shape
    _, W, Hkv, Dv = v.shape
    if Sq != 1 or k.shape != (B, W, Hkv, Dh) or v.shape[:3] != (B, W, Hkv):
        raise ValueError(f"decode_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if v.dtype != k.dtype:
        raise ValueError(f"decode_attention_fwd: k is {k.dtype} but v is "
                         f"{v.dtype}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or Dh > D_MAX or Dv > D_MAX:
        raise ValueError(f"decode_attention_fwd takes a GQA group <= "
                         f"{MAX_GROUP} and head dims <= {D_MAX}, got "
                         f"Hq={Hq} Hkv={Hkv} Dh={Dh} Dv={Dv}")
    for name, t, shape in (("q_positions", q_positions, (B,)),
                           ("kv_positions", kv_positions, (B, W))):
        if t.dtype != torch.int32 or t.device != q.device \
                or tuple(t.shape) != shape:
            raise ValueError(f"decode_attention_fwd: {name} must be int32 "
                             f"{shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("decode_attention_fwd: q, k, v on different devices")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    S = decode_splits(B, Hkv, W, sm_count(q.device.index),
                      decode_blocks_per_sm(Dh, Dv, Hq // Hkv))
    # the splits' unnormalized (m, l, acc) rows; S = 1 writes `out` directly
    ws = (torch.empty((B, Hq, S, Dv + 2), dtype=torch.float32,
                      device=q.device) if S > 1 else None)
    check(library().sfp_decode_attention_fwd(
        q.data_ptr(), q_code, k.data_ptr(), v.data_ptr(), kv_code,
        q_positions.data_ptr(), kv_positions.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, W, Hq, Hkv, Dh, Dv, S,
        q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), q_positions.stride(0),
        kv_positions.stride(0), kv_positions.stride(1), out.stride(0),
        out.stride(2), int(sliding_window or 0), float(softcap or 0.0),
        float(scale), current_stream()), "sfp_decode_attention_fwd")
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0


def grouped_decode(q, k, v, q_positions, kv_positions, *, scale,
                   sliding_window, softcap):
    """Grouped single-query attention without the GQA head repeat: the
    (B, W, Hkv) cache is contracted directly against (B, Hkv, G) query rows,
    so memory traffic stays at the KV-cache footprint instead of group x."""
    B, Sq, Hq, Dh = q.shape
    _, W, Hkv, Dv = v.shape
    G = Hq // Hkv
    qg = q[:, 0].reshape(B, Hkv, G, Dh).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = q_positions[:, None]
    valid = (kv_positions >= 0) & (kv_positions <= qp)
    if sliding_window is not None:
        valid = valid & (kv_positions > qp - sliding_window)
    s = torch.where(valid[:, None, None, :], s, s.new_full((), MASK_VALUE))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return out.reshape(B, 1, Hq, Dv).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, Hq, Dh) — ONE token per slot
    k: torch.Tensor,              # (B, W, Hkv, Dh) — the slot's KV cache
    v: torch.Tensor,              # (B, W, Hkv, Dv)
    *,
    q_positions: torch.Tensor,    # (B,) absolute position of the query
    kv_positions: torch.Tensor,   # (B, W) absolute positions, -1 = empty
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-query cache-read attention for the decode hot path.
    `causal=False` is rejected: decode attention is causal by construction."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-query, got {q.shape}")
    if not causal:
        raise ValueError("decode attention is causal by construction")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_cuda(q):
        return grouped_decode(q, k, v, q_positions, kv_positions, scale=scale,
                              sliding_window=sliding_window, softcap=softcap)
    return decode_attention_fwd(
        q, k, v, q_positions.to(torch.int32), kv_positions.to(torch.int32),
        scale=scale, sliding_window=sliding_window, softcap=softcap)


# ----------------------------------------------------------- paged variant
def paged_decode_attention_fwd(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               q_positions: torch.Tensor,
                               kv_positions: torch.Tensor, *, scale: float,
                               sliding_window: Optional[int],
                               softcap: Optional[float]) -> torch.Tensor:
    """q (B, 1, Hq, Dh), k_pool (P, page, Hkv, Dh), v_pool (P, page, Hkv,
    Dv) CUDA with unit stride on head_dim, q f32, bf16 or f16, the pools one
    dtype, f32, bf16 or f16; block_tables (B, nb), q_positions (B,) and
    kv_positions (P, page) int32 on the same device. The table's page ids
    must lie in [0, P): the engine allocates them from the pool, and
    checking here would need a device sync. Returns (B, 1, Hq, Dv) in q's
    dtype."""
    refuse_grad("paged_decode_attention_fwd", q, k_pool, v_pool)
    q_code = dtype_code("paged_decode_attention_fwd: q", q.dtype)
    kv_code = dtype_code("paged_decode_attention_fwd: k_pool", k_pool.dtype)
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_cuda or t.dim() != 4:
            raise ValueError(f"paged_decode_attention_fwd: {name} must be a "
                             f"4-D CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"paged_decode_attention_fwd: {name} needs unit "
                             f"stride on head_dim")
    B, Sq, Hq, Dh = q.shape
    P, page, Hkv, Dv = v_pool.shape
    if Sq != 1 or k_pool.shape != (P, page, Hkv, Dh):
        raise ValueError(f"paged_decode_attention_fwd: shapes q "
                         f"{tuple(q.shape)} k_pool {tuple(k_pool.shape)} "
                         f"v_pool {tuple(v_pool.shape)} disagree")
    if v_pool.dtype != k_pool.dtype:
        raise ValueError(f"paged_decode_attention_fwd: k_pool is "
                         f"{k_pool.dtype} but v_pool is {v_pool.dtype}")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP or Dh > D_MAX or Dv > D_MAX:
        raise ValueError(f"paged_decode_attention_fwd takes a GQA group <= "
                         f"{MAX_GROUP} and head dims <= {D_MAX}, got "
                         f"Hq={Hq} Hkv={Hkv} Dh={Dh} Dv={Dv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"paged_decode_attention_fwd: block_tables must be "
                         f"(B={B}, nb), got {tuple(block_tables.shape)}")
    nb = block_tables.shape[1]
    for name, t, shape in (("block_tables", block_tables, (B, nb)),
                           ("q_positions", q_positions, (B,)),
                           ("kv_positions", kv_positions, (P, page))):
        if t.dtype != torch.int32 or t.device != q.device \
                or tuple(t.shape) != shape:
            raise ValueError(f"paged_decode_attention_fwd: {name} must be "
                             f"int32 {shape} on {q.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if len({q.device, k_pool.device, v_pool.device}) != 1:
        raise ValueError("paged_decode_attention_fwd: q and the pools on "
                         "different devices")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    out = torch.empty((B, 1, Hq, Dv), dtype=q.dtype, device=q.device)
    S = decode_splits(B, Hkv, nb * page, sm_count(q.device.index),
                      decode_blocks_per_sm(Dh, Dv, Hq // Hkv))
    # the splits' unnormalized (m, l, acc) rows; S = 1 writes `out` directly
    ws = (torch.empty((B, Hq, S, Dv + 2), dtype=torch.float32,
                      device=q.device) if S > 1 else None)
    check(library().sfp_paged_decode_attention_fwd(
        q.data_ptr(), q_code, k_pool.data_ptr(), v_pool.data_ptr(), kv_code,
        block_tables.data_ptr(), q_positions.data_ptr(),
        kv_positions.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, nb, page, Hq, Hkv, Dh,
        Dv, S, q.stride(0), q.stride(2), k_pool.stride(0), k_pool.stride(1),
        k_pool.stride(2), v_pool.stride(0), v_pool.stride(1),
        v_pool.stride(2), block_tables.stride(0), block_tables.stride(1),
        q_positions.stride(0), kv_positions.stride(0),
        kv_positions.stride(1), out.stride(0), out.stride(2),
        int(sliding_window or 0), float(softcap or 0.0), float(scale),
        current_stream()), "sfp_paged_decode_attention_fwd")
    paged_decode_attention_fwd.launches += 1
    return out


paged_decode_attention_fwd.launches = 0


def paged_gather_decode(q, k_pool, v_pool, block_tables, q_positions,
                        kv_positions, *, scale, sliding_window, softcap):
    """Gather each slot's pages into the dense (B, nb * page) view — block
    j covers width indices [j * page, (j + 1) * page) — and attend it with
    `grouped_decode`."""
    B, nb = block_tables.shape
    P, page, Hkv, Dh = k_pool.shape
    bt = block_tables.long()
    kg = k_pool[bt].reshape(B, nb * page, Hkv, Dh)
    vg = v_pool[bt].reshape(B, nb * page, Hkv, v_pool.shape[-1])
    kvp = kv_positions[bt].reshape(B, nb * page)
    return grouped_decode(q, kg, vg, q_positions, kvp, scale=scale,
                          sliding_window=sliding_window, softcap=softcap)


def paged_decode_attention(
    q: torch.Tensor,              # (B, 1, Hq, Dh) — ONE token per slot
    k: torch.Tensor,              # (P, page, Hkv, Dh) — the page POOL
    v: torch.Tensor,              # (P, page, Hkv, Dv)
    *,
    block_tables: torch.Tensor,   # (B, n_blocks) int32 physical page ids
    q_positions: torch.Tensor,    # (B,) absolute position of the query
    kv_positions: torch.Tensor,   # (P, page) absolute positions, -1 = empty
    causal: bool = True,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """`decode_attention` against a page pool: slot b's keys live in pool
    pages `block_tables[b]` (logical block j = width range
    [j * page, (j + 1) * page)). Unallocated blocks point at the null page
    whose positions are -1, so they mask out like empty ring slots."""
    if q.shape[1] != 1:
        raise ValueError(f"decode_attention is single-query, got {q.shape}")
    if not causal:
        raise ValueError("decode attention is causal by construction")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not on_cuda(q):
        return paged_gather_decode(
            q, k, v, block_tables, q_positions, kv_positions, scale=scale,
            sliding_window=sliding_window, softcap=softcap)
    return paged_decode_attention_fwd(
        q, k, v, block_tables.to(torch.int32), q_positions.to(torch.int32),
        kv_positions.to(torch.int32), scale=scale,
        sliding_window=sliding_window, softcap=softcap)
