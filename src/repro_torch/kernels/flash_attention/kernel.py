"""Launch wrapper of the causal GQA prefill attention CUDA kernels.

Replaces the TPU kernel `repro/kernels/flash_attention/kernel.py::
flash_attention_fwd` with two kernels behind one C entry point. f32 q, k
and v take `csrc/flash_attention.cu`: QK^T and PV on the tensor cores at
fp32 accuracy (3xTF32 mma.sync), K/V tiles in a ring of cp.async buffers,
Q's TF32 halves split once (into registers up to head dim 128), K and V
split as loaded; head dims up to 160 in the narrow layout (64, 32 or 16
rows a block, two warps a 16-row tile; the rows of a GQA group's heads
stacked in one block, so K/V are read once a group; a key split merged by
the decode kernels' combine where the blocks do not fill the card, as
`prefill_plan` chooses), 192 and 256 in a wide one (four warps a 16-row
tile splitting QK^T's head dims, their partial scores summed through
shared memory, each warp a quarter of the value columns; 16 or 32 query
rows a block as `prefill_plan` chooses). bf16 and f16 q, k and v take
`csrc/flash_attention_16.cu`: 16-bit Q, K and V tiles by cp.async in a
ring of 2 or 3 stages, QK^T and PV on m16n8k16 16-bit tensor cores
(exact products, f32 sums) with P as three bf16 or two f16 terms (f32
accuracy: never rounded once to 16 bits), one layout up to head dim 256,
64, 32 or 16 query rows a block as `prefill_plan` chooses. Both read q, k
and v in the model's (B, S, H, Dh) layout through strides, so none of the
TPU wrapper's transpose, reshape and pad copies exist, and mask the ragged
Sq/Skv edge themselves; the entry point picks 16-byte copies from the
pointers and strides (else 4-byte copies at f32, plain loads at 16 bits).
q, k and v are of one dtype, f32, bf16 or f16, read by the kernel itself,
and the output is in their dtype, as the TPU kernel's. See the notes in
the sources for the tiling.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import dtype_code, refuse_grad
from repro_torch.kernels.build import check, current_stream, library

D_MAX = 256   # csrc/attention_common.cuh: kDMax
TILE_KEYS = 32   # keys a K/V tile (csrc/attention_common.cuh: kBK)
SM_SHARED_BYTES = 233_472    # shared memory of an H100 SM (228 KB)
BLOCK_RESERVED_BYTES = 1024  # the runtime's own shared memory a block
SM_REGISTERS = 65_536
# the kernels' width classes: 8-column steps of max(Dh, Dv)
WIDTHS = (4, 8, 10, 16, 20, 24, 32)
# rows a narrow f32 block (csrc/flash_attention.cu: flash_narrow_kernel,
# 4 x rows threads), largest first
F32_ROWS = (64, 32, 16)
F32_Q_REG = 16            # csrc/flash_attention.cu: kQRegND (Q's halves in
#                           registers up to this width class, else shared)
F32_STAGES3 = 10          # csrc/flash_attention.cu: kStages3ND (three K/V
#                           buffers up to this width class, else two)
MAX_SPLITS = 8            # csrc/decode_common.cuh: kMaxSplits (the combine)
# a narrow f32 key split gives each share at least this many 32-key tiles
F32_SPLIT_TILES = 4
# ... and launches at least this many blocks an SM
F32_SPLIT_BLOCKS_PER_SM = 2
# registers a thread of the narrow f32 kernel takes at each width class, as
# allocated (ptxas's count, under __launch_bounds__(256, 1), rounded up to
# 8; chip_smoke.py fails if a build takes more)
F32_NARROW_REGISTERS = {4: 152, 8: 168, 10: 192, 16: 232, 20: 224}
F32_WIDE = 24             # csrc/flash_attention.cu: kWideND
# values of at most this width under keys of class F32_WIDE (MLA's 192 /
# 128) take V's own width class, 16, in the wide f32 layout
F32_WIDE_V16 = 128
ROWS_F32_WIDE = (32, 16)  # query rows a wide f32 block, largest first
# wide f32: 32 rows only past this many query rows (more than five 32-key
# tiles a causal block's run), where the 32-row grid fills the card
F32_WIDE_ROWS32_FROM = 161
ROWS_16 = (64, 32, 16)    # query rows a 16-bit block, largest first
WIDE_16 = 20              # csrc/flash_attention_16.cu: Shape16::kWide
# csrc/flash_attention_16.cu: Shape16::kMinBlocks, the blocks of 256
# threads an SM must hold (__launch_bounds__): 2 (at most 128 registers a
# thread) but at width classes 10, 16 and 32, 1 (255, allocated as 256)
MIN_BLOCKS_16 = {10: 1, 16: 1, 32: 1}


class PrefillPlan(NamedTuple):
    """What the prefill kernel launches: `rows` rows a block (4 x rows
    threads at 16 bits and in the narrow f32 layout, 8 x rows in the wide
    f32 one), width class `nd`, the block's dynamic shared memory and the
    blocks of it an SM holds; narrow f32 only, `splits` key shares of each
    block row (merged by the combine) and `group` query heads a block (a
    divisor of G; a block's row m is query position m // group of head m %
    group)."""
    rows: int
    nd: int
    shared_bytes: int
    blocks_per_sm: int
    splits: int = 1
    group: int = 1


def prefill_width(Dh: int, Dv: int) -> int:
    """The width class of a call: the smallest of WIDTHS holding
    max(Dh, Dv) in 8-column steps."""
    d8 = -(-max(Dh, Dv) // 8)
    return next(nd for nd in WIDTHS if d8 <= nd)


def prefill_v_width(nd: int, Dv: int, itemsize: int) -> int:
    """V's width class in shared memory: the call's class `nd`, but 16 in
    the wide f32 layout's class 24 when Dv <= F32_WIDE_V16."""
    return 16 if itemsize == 4 and nd == F32_WIDE and Dv <= F32_WIDE_V16 \
        else nd


def prefill_shared_bytes(nd: int, rows: int, itemsize: int,
                         nv: Optional[int] = None) -> int:
    """Dynamic shared memory of a block (csrc's narrow_bytes32,
    wide_bytes32 and block_bytes16). f32, rows of 8 nd floats, V's padded
    by 4: narrow, Q of `rows` rows (plain, or its two TF32 halves above nd
    F32_Q_REG) and three K and V buffers of plain values up to nd
    F32_STAGES3, else two; wide from nd F32_WIDE, Q of `rows` rows (whose
    rows then hold the row tiles' score exchanges) and two K and V buffers
    of plain values, V's rows of 8 nv + 4 (`prefill_v_width`, default nd).
    16 bits: Q of `rows` rows and a ring of K and V tiles
    (Shape16::kStages of kKeys: 2 of 64 keys where the two warps of a row
    tile split the keys, 3 or 2 of 32 from nd WIDE_16, where they split
    V's columns), rows of 8 nd + 8 values, plus the wide split's score
    exchange (2 KB a row tile)."""
    if itemsize == 4:
        ldk, ldv = 8 * nd, 8 * nd + 4
        if nd >= F32_WIDE:
            ldv = 8 * (nv or nd) + 4
            return (rows * ldk + 2 * TILE_KEYS * (ldk + ldv)) * 4
        q_rows = rows * (1 if nd <= F32_Q_REG else 2)
        stages = 3 if nd <= F32_STAGES3 else 2
        return (q_rows * ldk + stages * TILE_KEYS * (ldk + ldv)) * 4
    ld = 8 * nd + 8
    if nd >= WIDE_16:
        keys, stages, exchange = 32, 3 if nd <= 24 else 2, rows // 16 * 2048
    else:
        keys, stages, exchange = 64, 2, 0
    return 2 * (rows * ld + stages * 2 * keys * ld) + exchange


def max_registers_16(nd: int) -> int:
    """Registers a thread of the 16-bit kernel may take at width class nd
    (its launch bounds' cap, as allocated)."""
    return SM_REGISTERS // (256 * MIN_BLOCKS_16.get(nd, 2))


def prefill_blocks_per_sm(nd: int, rows: int, itemsize: int,
                          nv: Optional[int] = None) -> int:
    """Blocks an SM holds by shared memory and by registers: narrow f32
    blocks of rows / 8 warps at F32_NARROW_REGISTERS a thread; wide f32
    blocks of 8 x rows threads at up to 255 registers (allocated as 256);
    16 bits `max_registers_16` a thread at most."""
    per = prefill_shared_bytes(nd, rows, itemsize, nv) + BLOCK_RESERVED_BYTES
    if itemsize == 4 and nd >= F32_WIDE:
        cap = SM_REGISTERS // (8 * rows * 256)
    elif itemsize == 4:
        warps = SM_REGISTERS // (32 * F32_NARROW_REGISTERS[nd])
        cap = warps // (rows // 8)
    else:
        cap = SM_REGISTERS // (4 * rows * max_registers_16(nd))
    return max(1, min(cap, SM_SHARED_BYTES // per))


def narrow_f32_plan(B: int, Sq: int, Hq: int, Hkv: int, kv_len: int,
                    sms: int) -> tuple:
    """(rows, splits, group) of the narrow f32 layout, the rule that the
    row, split and group sweep on the H100 gave (PERF.md has it):
    group: all G = Hq / Hkv heads of a kv head in one block where G divides
    16 (a row tile then holds whole query positions and no padding row;
    qwen2-vl's G 8, stablelm's and phi3.5-moe's G 4), else one head a block
    (Qwen2.5-14B's G 5). rows: 16 where one row tile holds every query row
    (Sq x group <= 16: a decode step's cross-attention); 64 where that
    grid is one wave of at least two thirds of the SMs while the
    32-row one would put two blocks on some SM (Qwen2.5-14B's 40 heads and
    zamba2's 32 at S 132), halving the K/V copies a row; else 32, which
    holds three blocks an SM at head dim 64 (ViT, whisper's encoder).
    splits: where the blocks number fewer than `sms`, key shares of at
    least F32_SPLIT_TILES 32-key tiles of kv_len, at most MAX_SPLITS:
    of the counts that launch F32_SPLIT_BLOCKS_PER_SM blocks an SM (fewer
    leave an SM too few warps to hide its copies), the one whose busiest
    SM walks the fewest tiles (ceil(blocks x S / sms) x ceil(tiles / S)),
    the smaller on a tie; the most the tiles allow where none reaches it
    (whisper's cross-attention over 1500 frames: 32 (b, h) rows of Sq 1
    split 8 ways, of Sq 64 in 32-row blocks 6 ways)."""
    G = Hq // Hkv
    group = G if 16 % G == 0 else 1

    def blocks(r):
        return -(-Sq // (r // group)) * (Hq // group) * B

    if Sq * group <= 16:
        rows = 16
    elif 3 * blocks(64) >= 2 * sms and blocks(64) <= sms < blocks(32):
        rows = 64
    else:
        rows = 32
    splits, n = 1, blocks(rows)
    if n < sms:
        tiles = -(-kv_len // TILE_KEYS)
        cap = max(1, min(MAX_SPLITS, tiles // F32_SPLIT_TILES))
        low = min(cap, -(-F32_SPLIT_BLOCKS_PER_SM * sms // n))
        splits = min(range(low, cap + 1), key=lambda s: (
            -(-n * s // sms) * -(-tiles // s), s))
    return rows, splits, group


def prefill_plan(B: int, Sq: int, Hq: int, Dh: int, Dv: int, itemsize: int,
                 sms: int = 132, *, Hkv: Optional[int] = None,
                 kv_len: Optional[int] = None) -> PrefillPlan:
    """The prefill kernel's launch for (B, Sq, Hq) queries over Hkv kv
    heads (default Hq) and kv_len keys (default Sq) of head dims Dh / Dv
    at `itemsize` bytes a value on a card of `sms` SMs. Narrow f32 (below
    width class F32_WIDE): `narrow_f32_plan`. 16 bits: the largest of 64,
    32 and 16 rows that launches at least `sms` blocks (ceil(Sq / rows) x
    Hq x B), else 16: Qwen2.5-14B's 40 heads at S 132 take 32 (200 blocks,
    against 120 at 64), gemma2-9b's 16 take 16 (144). Wide f32: 16 rows,
    or 32 from Sq F32_WIDE_ROWS32_FROM on where 32-row blocks still number
    `sms`. On the H100 16 rows were the faster at S 37 to 132 for all four
    wide serving shapes (a 32-row block's first row tile idles on the
    causal diagonal's last tile, a large share of a short run), 32 from S
    192 where the grid stays full (half the K/V copies a query row);
    PERF.md has the sweep. A function of shapes alone, so choosing it
    needs no device sync."""
    nd = prefill_width(Dh, Dv)
    splits = group = 1
    if itemsize == 4 and nd < F32_WIDE:
        rows, splits, group = narrow_f32_plan(
            B, Sq, Hq, Hkv or Hq, Sq if kv_len is None else kv_len, sms)
    elif itemsize == 4:
        rows = 32 if (Sq >= F32_WIDE_ROWS32_FROM
                      and -(-Sq // 32) * Hq * B >= sms) else 16
    else:
        rows = next((r for r in ROWS_16[:-1]
                     if -(-Sq // r) * Hq * B >= sms), ROWS_16[-1])
    nv = prefill_v_width(nd, Dv, itemsize)
    return PrefillPlan(rows, nd, prefill_shared_bytes(nd, rows, itemsize, nv),
                       prefill_blocks_per_sm(nd, rows, itemsize, nv),
                       splits, group)


def check_plan(plan: PrefillPlan, Dh: int, Dv: int, itemsize: int,
               G: int = 1) -> None:
    """Raise unless `plan` launches these widths at this itemsize and GQA
    group G: narrow f32 takes 64, 32 or 16 rows, 1 to MAX_SPLITS splits and
    a group dividing G of at most the rows; wide f32 32 or 16 rows, 16 bits
    64, 32 or 16, both without a split or a group; the width class must be
    the call's."""
    nd = prefill_width(Dh, Dv)
    narrow = itemsize == 4 and nd < F32_WIDE
    rows_ok = (ROWS_16 if itemsize == 2 else
               ROWS_F32_WIDE if nd >= F32_WIDE else F32_ROWS)
    if narrow:
        shape_ok = (1 <= plan.splits <= MAX_SPLITS and plan.group >= 1
                    and G % plan.group == 0 and plan.group <= plan.rows)
    else:
        shape_ok = plan.splits == 1 and plan.group == 1
    if plan.rows not in rows_ok or plan.nd != nd or not shape_ok:
        raise ValueError(f"flash_attention_fwd: plan {plan} does not launch "
                         f"Dh {Dh}, Dv {Dv} at {itemsize} B a value and "
                         f"group {G}")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device, read once a device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, sliding_window: Optional[int],
                        softcap: Optional[float], scale: float,
                        kv_len: int,
                        plan: Optional[PrefillPlan] = None) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k (B, Skv, Hkv, Dh), v (B, Skv, Hkv, Dv): CUDA
    tensors of one dtype, f32, bf16 or f16, with unit stride on the last axis;
    keys at or past `kv_len` are absent. `plan` overrides `prefill_plan`
    (the card tests force each row count, split count and group). Returns
    (B, Sq, Hq, Dv) in q's dtype."""
    refuse_grad("flash_attention_fwd", q, k, v)
    code = dtype_code("flash_attention_fwd: q", q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != q.dtype or t.dim() != 4:
            raise ValueError(f"flash_attention_fwd: {name} must be a 4-D "
                             f"{q.dtype} CUDA tensor, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_fwd: {name} needs unit stride "
                             f"on head_dim")
    B, Sq, Hq, Dh = q.shape
    _, Skv, Hkv, Dv = v.shape
    if k.shape != (B, Skv, Hkv, Dh) or v.shape[:3] != (B, Skv, Hkv) \
            or len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"flash_attention_fwd: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} disagree")
    if Hq % Hkv or Dh > D_MAX or Dv > D_MAX:
        raise ValueError(f"flash_attention_fwd takes Hq % Hkv == 0 and "
                         f"head dims <= {D_MAX}, got Hq={Hq} Hkv={Hkv} "
                         f"Dh={Dh} Dv={Dv}")
    if not 1 <= kv_len <= Skv:
        raise ValueError(f"flash_attention_fwd: kv_len {kv_len} outside "
                         f"[1, {Skv}]")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window must be >= 1, got {sliding_window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    itemsize = q.element_size()
    if plan is None:
        plan = prefill_plan(B, Sq, Hq, Dh, Dv, itemsize,
                            sm_count(q.device.index), Hkv=Hkv, kv_len=kv_len)
    check_plan(plan, Dh, Dv, itemsize, Hq // Hkv)
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device)
    # a key split's (m, l, acc) rows, merged into `out` by the combine
    ws = (torch.empty(B * Sq * Hq * plan.splits * (Dv + 2),
                      dtype=torch.float32, device=q.device)
          if plan.splits > 1 else None)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    check(library().sfp_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code,
        B, Sq, Skv, Hq, Hkv, Dh, Dv, *strides, int(causal),
        int(sliding_window or 0), float(softcap or 0.0), float(scale),
        int(kv_len), plan.rows, plan.splits, plan.group,
        None if ws is None else ws.data_ptr(), current_stream()),
        "sfp_flash_attention_fwd")
    flash_attention_fwd.launches += 1
    if flash_attention_fwd.shapes is not None:
        flash_attention_fwd.shapes[(B, Sq, Skv, Hq, Hkv, Dh, Dv,
                                    bool(causal), int(kv_len))] += 1
    return out


flash_attention_fwd.launches = 0
# a collections.Counter to count launches by (B, Sq, Skv, Hq, Hkv, Dh, Dv,
# causal, kv_len), or None (counting off); reset_launches clears it
flash_attention_fwd.shapes = None
