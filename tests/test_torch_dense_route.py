"""PyTorch port: the choice between the dense attention kernels' two routes.

`fa.dense_resident` decides, from the resident kernels' shared-memory layout
and register budget, which dense shapes take the kernels that hold a whole
(batch, head) in one CTA (ops/csrc/attn_fwd.cu, attn_bwd.cu with
attn_dense.cuh); the others take the wide kernels. Pure Python: the kernels
themselves are held to their twins on the card in
tests/test_torch_kernels_gpu.py.
"""

import pytest
import torch

from vit_rpe_rope_tpu_torch.configs import ViTConfig
from vit_rpe_rope_tpu_torch.ops import flash_attention as fa


@pytest.mark.parametrize("n,d,backward,expected", [
    # 3 (forward) or 4 (backward) bf16 tiles [round16(N), D + 8], and in
    # the backward three f32 row vectors (max, sum, delta) of round16(N).
    (197, 64, False, 3 * 208 * 72 * 2),
    (197, 64, True, 4 * 208 * 72 * 2 + 3 * 208 * 4),
    (197, 128, True, 4 * 208 * 136 * 2 + 3 * 208 * 4),
    (65, 32, False, 3 * 80 * 40 * 2),
    (65, 32, True, 4 * 80 * 40 * 2 + 3 * 80 * 4),
    (50, 32, True, 4 * 64 * 40 * 2 + 3 * 64 * 4),
    (1, 16, True, 4 * 16 * 24 * 2 + 3 * 16 * 4),
])
def test_resident_smem_bytes_by_hand(n, d, backward, expected):
    assert fa.resident_smem_bytes(n, d, backward) == expected


def test_resident_block_cap_is_the_register_budget():
    # 8 score registers per 16-key block and per thread, beside 24 others,
    # within 65,536 registers over the CTA's threads rounded up to 4 warps.
    assert fa._resident_regs(5) == 255
    assert fa._resident_regs(12) == 65536 // 384
    assert fa._resident_regs(13) == fa._resident_regs(16) == 128
    assert fa.RESIDENT_MAX_BLOCKS == 13
    assert 8 * 13 + fa.RESIDENT_OTHER_REGS <= 128
    assert 8 * 14 + fa.RESIDENT_OTHER_REGS > 128


def test_largest_resident_backward_fits_shared_memory():
    # D = 128 at 13 blocks is the largest CTA: 228,800 of 232,448 bytes.
    assert fa.resident_smem_bytes(208, 128, True) <= fa.SMEM_BYTES
    assert fa.dense_resident(6, 208, 128, True)
    assert not fa.dense_resident(6, 209, 64, False)


def _kernel_head_dim(d):
    """The head dim the kernels run at (fa.HeadPad pads the others)."""
    return d if d in fa.HEAD_DIMS else fa.HeadPad(d, False).d_pad


@pytest.mark.parametrize("label,cfg", [
    ("mnist", ViTConfig(img_size=28, patch_size=4, in_chans=1)),
    ("vit_tiny4", ViTConfig()),
    ("vit_tiny4_4_heads", ViTConfig(num_heads=4)),
    ("vit_s16_224", ViTConfig(img_size=224, patch_size=16, embed_dim=384,
                              depth=12, num_heads=6)),
])
@pytest.mark.parametrize("has_bias", [False, True])
def test_repo_dense_shapes_take_the_resident_route(label, cfg, has_bias):
    h, n = cfg.num_heads, cfg.seq_len
    assert fa.use_dense(h, n, has_bias), label
    assert fa.dense_resident(h, n, _kernel_head_dim(cfg.head_dim), has_bias)
    for d in fa.HEAD_DIMS:  # at every head dim the kernels are built for
        assert fa.dense_resident(h, n, d, has_bias), (label, d)


def test_repo_dense_sequence_lengths():
    assert ViTConfig(img_size=28, patch_size=4).seq_len == 50
    assert ViTConfig().seq_len == 65
    assert ViTConfig(img_size=224, patch_size=16).seq_len == 197


@pytest.mark.parametrize("h", [1, 2, 4, 6, 8, 12, 16])
def test_nothing_outside_use_dense_is_resident(h):
    for n in list(range(1, 400)) + [577, 1025, 2048, 2049, 4097]:
        for d in fa.HEAD_DIMS + (48, 256):
            for has_bias in (False, True):
                if fa.dense_resident(h, n, d, has_bias):
                    assert fa.use_dense(h, n, has_bias), (h, n, d)
                    assert d in fa.HEAD_DIMS
                    assert n <= 16 * fa.RESIDENT_MAX_BLOCKS


@pytest.mark.parametrize("b,h,n,budget,expected", [
    (64, 6, 197, None, 64),               # every slab fits: one per batch
    (1, 6, 65, None, 1),
    (9, 2, 65, 3 * 2 * 65 * 68 * 4, 3),   # 3 slabs fit: runs of 3
    (7, 2, 65, 3 * 2 * 65 * 68 * 4, 3),   # runs 3, 3, 1
    (9, 2, 65, 0, 1),                     # nothing fits: one run of all
    (16, 6, 197, 8 * 6 * 197 * 200 * 4, 8),
])
def test_resident_dbias_runs(b, h, n, budget, expected):
    """The resident backward's slabs have rows padded to 4 floats."""
    slabs = fa.dbias_groups(b, h, n, budget, fa._round_up(n, 4))
    assert slabs == expected
    per = -(-b // slabs)  # batches per CTA, as attention_bwd passes it
    assert (slabs - 1) * per < b <= slabs * per
    if budget is not None and budget >= h * n * fa._round_up(n, 4) * 4:
        assert slabs * h * n * fa._round_up(n, 4) * 4 <= budget


def test_aligned_copies_only_rows_the_kernels_cannot_load():
    x = torch.zeros(2, 3, 5, 32)
    assert fa._aligned(x) is x
    qkv = torch.zeros(2, 5, 3, 3, 32).permute(2, 0, 3, 1, 4)
    k = qkv[1]
    assert fa._aligned(k) is k  # the model's strided views
    odd = torch.zeros(2, 3, 5, 17)[..., :16]  # 68-byte rows
    got = fa._aligned(odd)
    assert got is not odd and got.is_contiguous()
    assert torch.equal(got, odd)
    assert fa._aligned(None) is None


def test_cpu_wrappers_count_no_route():
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 3, 17, 16, generator=gen) for _ in range(4))
    before = (fa.LAUNCHES_RESIDENT, fa.LAUNCHES_WIDE,
              fa.LAUNCHES_BWD_RESIDENT, fa.LAUNCHES_BWD_WIDE)
    out = fa.attention_fwd(q, k, v, 0.25)
    assert torch.equal(out, fa.attention_plain(q, k, v, 0.25))
    got = fa.attention_bwd(q, k, v, out, g, 0.25, dbias_budget=0)
    want = fa.attention_bwd_plain(q, k, v, out, g, 0.25)
    assert all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
    assert before == (fa.LAUNCHES_RESIDENT, fa.LAUNCHES_WIDE,
                      fa.LAUNCHES_BWD_RESIDENT, fa.LAUNCHES_BWD_WIDE)
