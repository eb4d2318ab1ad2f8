"""The prefill kernel's launch plan on the CPU
(`kernels/flash_attention/kernel.py::prefill_plan`): query rows a block,
width class, shared memory and blocks an SM, and the narrow f32 layout's
key split and GQA group, pinned to the values the CUDA sources compute
(their static_asserts) and to the paths' shapes that must fill an H100's
132 SMs."""
import torch

torch.set_num_threads(2)

import re  # noqa: E402
from pathlib import Path  # noqa: E402

import pytest  # noqa: E402

from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    F32_NARROW_REGISTERS, F32_Q_REG, F32_ROWS, F32_STAGES3, F32_WIDE,
    F32_WIDE_V16, MAX_SPLITS, MIN_BLOCKS_16, ROWS_16, ROWS_F32_WIDE, WIDTHS,
    PrefillPlan, check_plan, max_registers_16, prefill_blocks_per_sm,
    prefill_plan, prefill_shared_bytes, prefill_v_width, prefill_width)

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
BLOCK_MAX = 232_448   # dynamic shared memory a block may have on an H100


@pytest.mark.parametrize("itemsize", [2, 4])
def test_shared_bytes_fit_a_block_at_every_head_dim(itemsize):
    """Head dims 8-256 in steps of 8, values as wide as the keys or 128
    (MLA's), at every row count the plan can choose."""
    for d in range(8, 257, 8):
        for dv in {d, min(d, 128)}:
            nd = prefill_width(d, dv)
            for rows in (ROWS_16 if itemsize == 2 else
                         ROWS_F32_WIDE if nd >= F32_WIDE else F32_ROWS):
                assert prefill_shared_bytes(nd, rows, itemsize) <= BLOCK_MAX
            plan = prefill_plan(1, 132, 8, d, dv, itemsize)
            assert plan.shared_bytes <= BLOCK_MAX and plan.blocks_per_sm >= 1


@pytest.mark.parametrize("nd,rows,itemsize,nbytes,blocks", [
    # 16 bits: Q of `rows` rows and a ring of 2 K/V tiles of 64 keys (nd
    # <= 16), 3 of 32 (20, 24) or 2 of 32 (32), rows of 8 nd + 8 values;
    # 2 KB a row tile of score exchange from nd 20; blocks by shared
    # memory and the register cap (256 at nd 10, 16 and 32, else 128)
    (4, 64, 2, 25_600, 2), (4, 32, 2, 23_040, 4), (4, 16, 2, 21_760, 8),
    (8, 64, 2, 46_080, 2), (8, 32, 2, 41_472, 4), (8, 16, 2, 39_168, 5),
    (10, 64, 2, 56_320, 1), (10, 32, 2, 50_688, 2), (10, 16, 2, 47_872, 4),
    (16, 64, 2, 87_040, 1), (16, 32, 2, 78_336, 2), (16, 16, 2, 73_984, 3),
    (20, 64, 2, 94_208, 2), (20, 32, 2, 79_360, 2), (20, 16, 2, 71_936, 3),
    (24, 64, 2, 110_592, 2), (24, 32, 2, 93_696, 2), (24, 16, 2, 85_248, 2),
    (32, 64, 2, 109_568, 1), (32, 32, 2, 88_576, 2), (32, 16, 2, 78_080, 2),
    # narrow f32 (64, 32 or 16 rows, rows / 8 warps): Q of `rows` rows of
    # 8 nd floats (its two TF32 halves at nd 20) and three K and V buffers
    # of 32 keys up to nd 10, else two (V's rows padded by 4); blocks by
    # shared memory and by F32_NARROW_REGISTERS a thread
    (4, 64, 4, 34_304, 1), (4, 32, 4, 30_208, 3), (4, 16, 4, 28_160, 6),
    (8, 64, 4, 67_072, 1), (8, 32, 4, 58_880, 3), (8, 16, 4, 54_784, 4),
    (10, 64, 4, 83_456, 1), (10, 32, 4, 73_216, 2), (10, 16, 4, 68_096, 3),
    (16, 64, 4, 99_328, 1), (16, 32, 4, 82_944, 2), (16, 16, 4, 74_752, 3),
    (20, 64, 4, 164_864, 1), (20, 32, 4, 123_904, 1),
    (20, 16, 4, 103_424, 2),
    # wide f32 (32 or 16 rows, 8 x rows threads): Q of `rows` rows of 8 nd
    # floats and two K and V buffers of 32 keys (V's rows padded by 4);
    # two blocks of 16 rows at nd 24, else one
    (24, 16, 4, 111_616, 2), (24, 32, 4, 123_904, 1),
    (32, 16, 4, 148_480, 1), (32, 32, 4, 164_864, 1),
])
def test_plan_bytes_and_residency_pinned(nd, rows, itemsize, nbytes, blocks):
    assert prefill_shared_bytes(nd, rows, itemsize) == nbytes
    assert prefill_blocks_per_sm(nd, rows, itemsize) == blocks


def test_c_sources_compute_the_same_bytes():
    """Each source pins its block bytes for every width class (and, at 16
    bits, every row count) in static_asserts, which nvcc checks; they are
    the plan's numbers, and the 16-bit kernel's launch bounds are the
    plan's register cap."""
    src16 = (CSRC / "flash_attention_16.cu").read_text()
    got16 = {(int(nd), int(rows)): int(b) for nd, rows, b in re.findall(
        r"static_assert\(block_bytes16<(\d+)>\((\d+)\) == (\d+),", src16)}
    assert got16 == {(nd, rows): prefill_shared_bytes(nd, rows, 2)
                     for nd in WIDTHS for rows in ROWS_16}
    src32 = (CSRC / "flash_attention.cu").read_text()
    got32 = {(int(nd), int(rows)): int(b) for nd, rows, b in re.findall(
        r"static_assert\(narrow_bytes32<(\d+)>\((\d+)\) == (\d+),", src32)}
    assert got32 == {(nd, rows): prefill_shared_bytes(nd, rows, 4)
                     for nd in WIDTHS if nd < F32_WIDE for rows in F32_ROWS}
    for name, value in (("kQRegND", F32_Q_REG), ("kStages3ND", F32_STAGES3),
                        ("kNarrowThr", 4 * max(F32_ROWS))):
        assert re.search(rf"constexpr int {name} = (\d+);",
                         src32).group(1) == str(value)
    # the narrow kernel's launch bounds leave it up to 255 registers, which
    # F32_NARROW_REGISTERS pins per width class (chip_smoke.py holds the
    # build to them); a key split is merged by the decode kernels' combine
    assert re.search(r"__launch_bounds__\(kNarrowThr, 1\)\s+"
                     r"flash_narrow_kernel", src32)
    assert set(F32_NARROW_REGISTERS) == {nd for nd in WIDTHS
                                         if nd < F32_WIDE}
    assert all(r % 8 == 0 and r <= 256
               for r in F32_NARROW_REGISTERS.values())
    assert "decode_combine_kernel<<<" in src32
    common = (CSRC / "decode_common.cuh").read_text()
    assert re.search(r"constexpr int kMaxSplits = (\d+);",
                     common).group(1) == str(MAX_SPLITS)
    wide32 = {(int(nd), int(nv), int(rows)): int(b)
              for nd, nv, rows, b in re.findall(
                  r"static_assert\(wide_bytes32<(\d+), (\d+)>\((\d+)\) == "
                  r"(\d+),", src32)}
    assert wide32 == {(nd, nv, rows): prefill_shared_bytes(nd, rows, 4, nv)
                      for nd in WIDTHS if nd >= F32_WIDE
                      for nv in {nd, prefill_v_width(nd, F32_WIDE_V16, 4)}
                      for rows in ROWS_F32_WIDE}
    assert re.search(r"if \(p\.Dv <= (\d+)\)", src32).group(1) == \
        str(F32_WIDE_V16)
    assert re.search(r"constexpr int kWideND = (\d+);", src32).group(1) == \
        str(F32_WIDE)
    # the wide kernel's block is 8 x rows threads, 256 at most: the launch
    # bounds' register cap (255) is the plan's
    assert re.search(r"__launch_bounds__\(kWideThr, 1\)\s+flash_wide_kernel",
                     src32)
    assert re.search(r"constexpr int kWideThr = (\d+);", src32).group(1) == \
        str(8 * max(ROWS_F32_WIDE))
    assert re.search(r"__launch_bounds__\(256, Shape16<ND>::kMinBlocks\)\s+"
                     r"flash16_kernel", src16)
    assert 256 == 4 * max(ROWS_16)
    one = re.search(r"kMinBlocks = ND == (\d+) \|\| ND == (\d+) \|\| "
                    r"ND == (\d+) \? 1 : 2;", src16).groups()
    assert MIN_BLOCKS_16 == {int(nd): 1 for nd in one}
    assert [max_registers_16(nd) for nd in WIDTHS] == [128, 128, 256, 256,
                                                       128, 128, 256]


@pytest.mark.parametrize("label,Hq,Dh,Dv,itemsize,rows,blocks", [
    # 16 bits
    pytest.param("Qwen2.5-14B", 40, 128, 128, 2, 32, 200,  # 120 at 64 rows
                 id="Qwen2.5-14B-40-128-32-200"),
    pytest.param("zamba2", 32, 80, 80, 2, 32, 160,         # 96 at 64
                 id="zamba2-32-80-32-160"),
    pytest.param("gemma2-9b", 16, 256, 256, 2, 16, 144,    # 48 at 64, 80 at 32
                 id="gemma2-9b-16-256-16-144"),
    pytest.param("stablelm-12b", 32, 160, 160, 2, 32, 160,
                 id="stablelm-12b-32-160-32-160"),
    pytest.param("nemotron-4-340b", 96, 192, 192, 2, 64, 288,
                 id="nemotron-4-340b-96-192-64-288"),
    # the wide f32 layout (64 rows before it: 48, 192, 384, 288 blocks)
    pytest.param("gemma2-9b", 16, 256, 256, 4, 16, 144,
                 id="f32-gemma2-9b-16-256-16-144"),
    pytest.param("deepseek-v3 MLA, a rank's heads", 64, 192, 128, 4, 16, 576,
                 id="f32-mla-64-192-128-16-576"),
    pytest.param("deepseek-v3 MLA", 128, 192, 128, 4, 16, 1152,
                 id="f32-mla-128-192-128-16-1152"),
    pytest.param("nemotron-4-340b", 96, 192, 192, 4, 16, 864,
                 id="f32-nemotron-4-340b-96-192-16-864"),
])
def test_serving_prefill_fills_the_card(label, Hq, Dh, Dv, itemsize, rows,
                                        blocks):
    """Batch-1 prefill of the serving paths' longest prompt (132 = 128 +
    4 soft-prompt tokens) launches at least one block an SM at 16 bits
    and in the wide f32 layout."""
    plan = prefill_plan(1, 132, Hq, Dh, Dv, itemsize, sms=132)
    assert plan.rows == rows
    assert -(-132 // plan.rows) * Hq == blocks >= 132
    # where no row count reaches a wave (S 37 at Qwen's 40 heads: 120
    # blocks of 16 rows), the plan takes the smallest
    assert prefill_plan(1, 37, 40, 128, 128, 2).rows == 16
    assert prefill_plan(1, 37, 128, 192, 128, 4).rows == 16
    # many blocks already (ViT-Base scoring, 16 x 12 heads): 64 rows
    assert prefill_plan(16, 213, 12, 64, 64, 2).rows == 64


@pytest.mark.parametrize("label,shape,kw,want", [
    # (B, Sq, Hq, Dh, Dv), prefill_plan's Hkv and kv_len, and (rows, nd,
    # bytes, blocks an SM, splits, group)
    ("whisper-base cross-attention Sq 1 over 1500", (4, 1, 8, 64, 64),
     dict(Hkv=8, kv_len=1500), (16, 8, 54_784, 4, 8, 1)),
    ("whisper-base cross-attention Sq 64 over 1500", (4, 64, 8, 64, 64),
     dict(Hkv=8, kv_len=1500), (32, 8, 58_880, 3, 6, 1)),
    ("whisper-base encoder", (4, 1500, 8, 64, 64), dict(Hkv=8),
     (32, 8, 58_880, 3, 1, 1)),
    ("whisper-base decoder self-attention", (4, 68, 8, 64, 64), dict(Hkv=8),
     (32, 8, 58_880, 3, 1, 1)),
    ("qwen2-vl-72b, G 8", (2, 132, 64, 128, 128), dict(Hkv=8),
     (32, 16, 82_944, 2, 1, 8)),
    ("Qwen2.5-14B, G 5", (1, 132, 40, 128, 128), dict(Hkv=8),
     (64, 16, 99_328, 1, 1, 1)),
    ("Qwen2.5-14B a rank of 2", (1, 132, 20, 128, 128), dict(Hkv=4),
     (32, 16, 82_944, 2, 1, 1)),
    ("ViT-Base a rank of 2", (16, 213, 6, 64, 64), {},
     (32, 8, 58_880, 3, 1, 1)),
    ("ViT-Base", (16, 213, 12, 64, 64), {}, (32, 8, 58_880, 3, 1, 1)),
    ("stablelm-12b, G 4", (1, 132, 32, 160, 160), dict(Hkv=8),
     (32, 20, 123_904, 1, 1, 4)),
    ("zamba2", (1, 132, 32, 80, 80), {}, (64, 10, 83_456, 1, 1, 1)),
    ("phi3.5-moe, G 4", (1, 132, 32, 128, 128), dict(Hkv=8),
     (32, 16, 82_944, 2, 1, 4)),
    ("head dim 96, G 4", (1, 132, 32, 96, 96), dict(Hkv=8),
     (32, 16, 82_944, 2, 1, 4)),
    ("a decode step, G 2", (1, 1, 4, 64, 64), dict(Hkv=2),
     (16, 8, 54_784, 4, 1, 2)),
])
def test_f32_keeps_its_64_row_plan(label, shape, kw, want):
    """The narrow f32 layout's plan at the paths' shapes (it was 64 rows
    for every call before the row plan, the key split and the GQA group):
    rows, width class, the block's bytes (the C source's narrow_bytes32),
    blocks an SM, splits and group."""
    plan = prefill_plan(*shape, 4, **kw)
    assert plan == PrefillPlan(*want)
    assert plan.shared_bytes <= BLOCK_MAX


@pytest.mark.parametrize("shape,rows,nbytes,blocks", [
    ((1, 132, 16, 256, 256), 16, 148_480, 1),    # gemma2-9b
    ((2, 77, 24, 192, 128), 16, 95_232, 2),      # values of class 16
    ((1, 132, 64, 192, 128), 16, 95_232, 2),     # MLA, a rank's heads
    ((1, 132, 96, 192, 192), 16, 111_616, 2),    # nemotron-4-340b
    ((1, 1, 4, 256, 256), 16, 148_480, 1),
    ((1, 132, 8, 176, 176), 16, 111_616, 2),
    # 32 rows from S 161 where 32-row blocks fill the card
    ((1, 192, 64, 192, 128), 32, 107_520, 1),    # 6 x 64 blocks
    ((1, 528, 16, 256, 256), 32, 164_864, 1),    # 17 x 16 blocks
    ((1, 256, 16, 256, 256), 16, 148_480, 1),    # 8 x 16 < 132: 16 rows
    ((1, 160, 96, 192, 192), 16, 111_616, 2),    # five tiles: 16 rows
    ((2, 161, 96, 192, 192), 32, 123_904, 1),
])
def test_f32_wide_plan_pinned(shape, rows, nbytes, blocks):
    """The wide f32 layout's plan (width classes 24 and 32): its rows, the
    block's bytes (the C source's wide_bytes32) and blocks an SM."""
    plan = prefill_plan(*shape, 4)
    nd = prefill_width(*shape[3:])
    assert nd >= F32_WIDE
    assert plan == PrefillPlan(rows, nd, nbytes, blocks)
    assert nbytes <= BLOCK_MAX


def test_check_plan_refuses_what_cannot_launch():
    good = prefill_plan(1, 132, 40, 128, 128, 2)
    check_plan(good, 128, 128, 2)
    wide = prefill_plan(1, 132, 16, 256, 256, 4)
    for rows in ROWS_F32_WIDE:   # the wide f32 rows are accepted
        check_plan(wide._replace(rows=rows), 256, 256, 4)
        check_plan(wide._replace(rows=rows, nd=24), 192, 128, 4)
    narrow = prefill_plan(1, 132, 40, 128, 128, 4, Hkv=8)
    for rows in F32_ROWS:        # narrow f32: rows, splits, a group of G
        for splits in (1, MAX_SPLITS):
            for group in (1, 5):
                check_plan(narrow._replace(rows=rows, splits=splits,
                                           group=group), 128, 128, 4, 5)
    check_plan(narrow._replace(group=2), 128, 128, 4, 8)
    for plan, Dh, itemsize, G in (
            (good._replace(rows=48), 128, 2, 1),
            (good._replace(nd=10), 128, 2, 1),
            (good, 256, 2, 1),
            (good._replace(splits=2), 128, 2, 1),
            (good._replace(group=5), 128, 2, 5),
            (wide._replace(rows=64), 256, 4, 1),
            (wide._replace(rows=48), 256, 4, 1),
            (wide, 192, 4, 1),
            (wide._replace(splits=2), 256, 4, 1),
            (narrow._replace(rows=48), 128, 4, 5),
            (narrow._replace(splits=0), 128, 4, 5),
            (narrow._replace(splits=MAX_SPLITS + 1), 128, 4, 5),
            (narrow._replace(group=3), 128, 4, 5),
            (narrow._replace(group=0), 128, 4, 5),
            (narrow._replace(rows=16, group=32), 128, 4, 32),
            (narrow._replace(nd=20), 128, 4, 5)):
        with pytest.raises(ValueError, match="does not launch"):
            check_plan(plan, Dh, Dh, itemsize, G)
