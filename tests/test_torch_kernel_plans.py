"""The pure functions that choose the port's kernel launches, on the CPU.

``pdae_torch.ops.groupnorm.gn_plan`` picks the GN forward kernel's variant
(thread block cluster or one block per slab), cluster size and block size
from a slab's size and addresses; ``pdae_torch.ops.attention.attention_plan``
picks the attention kernel's tiling and computes its shared memory. The
kernels themselves run only on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); what is held here is that every shape of the
celeba64 paths (the b8 autoencode request, the b32 train step) gets the plan
the kernels were designed for, and that the limits hold.
"""

import os
import re

import pytest
import torch

from pdae_torch import ops
from pdae_torch.ops import attention, groupnorm, groupnorm_train

GROUPS = 32
# (channels, H=W, AdaGN, z) of every GN chain of one ShiftUNet evaluation and
# one encoder pass; the request runs them at batch 8, the train step at 32
GN_CHAINS = [
    (64, 32, False, False), (128, 4, False, False), (128, 8, False, False),
    (128, 16, False, False), (128, 32, False, False), (128, 32, True, False),
    (128, 64, False, False), (128, 64, True, False), (128, 64, True, True),
    (256, 8, False, False), (256, 8, True, False), (256, 16, False, False),
    (256, 16, True, False), (256, 16, True, True), (256, 32, False, False),
    (256, 32, True, False), (256, 32, True, True), (256, 64, False, False),
    (256, 64, True, False), (256, 64, True, True), (384, 32, False, False),
    (384, 64, False, False), (512, 8, False, False), (512, 8, True, False),
    (512, 8, True, True), (512, 16, False, False), (512, 16, True, False),
    (512, 16, True, True), (512, 32, False, False), (768, 8, False, False),
    (768, 16, False, False), (1024, 8, False, False)]
GN_COMBINATIONS = [(b, *chain) for b in (8, 32) for chain in GN_CHAINS]


def test_the_path_has_64_gn_combinations():
    assert len(GN_COMBINATIONS) == len(set(GN_COMBINATIONS)) == 64


@pytest.mark.parametrize("batch,channels,side,adagn,z", GN_COMBINATIONS)
def test_every_path_slab_goes_to_the_cluster_variant(batch, channels, side, adagn, z):
    hw = side * side
    for elt in (4, 2):                                   # fp32, bf16
        slab = channels // GROUPS * hw * elt
        plan = groupnorm.gn_plan(channels // GROUPS * hw, hw, elt)
        assert plan.variant == "cluster"
        assert plan.cluster in groupnorm.CLUSTER_SIZES
        assert plan.cluster * plan.part_bytes == slab    # an even split, read once
        assert plan.part_bytes % 16 == 0
        assert plan.part_bytes <= groupnorm.PART_BYTES == 65536
        assert 32 <= plan.threads <= groupnorm.MAX_THREADS and plan.threads % 32 == 0
        # the smallest cluster that fits: half as many blocks would not
        assert plan.cluster == 1 or slab // (plan.cluster // 2) > groupnorm.PART_BYTES


@pytest.mark.parametrize("slab_kb,cluster,threads", [(192, 4, 512), (128, 2, 512),
                                                     (64, 1, 512), (32, 1, 512),
                                                     (16, 1, 256), (8, 1, 256),
                                                     (1, 1, 64)])
def test_gn_plan_by_slab_size(slab_kb, cluster, threads):
    n = slab_kb * 1024 // 4
    plan = groupnorm.gn_plan(n, 64, 4)
    assert (plan.variant, plan.cluster, plan.threads) == ("cluster", cluster, threads)


@pytest.mark.parametrize("kwargs", [
    dict(n=12 * 4096, hw=4096, elt=4, x_ptr=4),          # x 4 bytes off
    dict(n=12 * 4096, hw=4096, elt=4, out_ptr=8),        # out 8 bytes off
    dict(n=2 * 9, hw=9, elt=4),                          # H*W no multiple of 4
    dict(n=4 * 12, hw=12, elt=2),                        # ... of 8 in bf16
    dict(n=2 * 384 * 384, hw=384 * 384, elt=4),          # over 8 x 64 KB
    dict(n=8 * 65536 // 4 + 32, hw=4, elt=4),            # just over
], ids=["x_misaligned", "out_misaligned", "ragged_fp32", "ragged_bf16", "oversized",
        "just_oversized"])
def test_what_the_cluster_variant_does_not_take_goes_to_the_general_one(kwargs):
    plan = groupnorm.gn_plan(**kwargs)
    assert plan == groupnorm.GENERAL
    assert (plan.variant, plan.cluster) == ("general", 0)


def test_the_largest_cluster_slab_is_taken():
    plan = groupnorm.gn_plan(8 * 65536 // 4, 4096, 4)
    assert (plan.variant, plan.cluster, plan.part_bytes) == ("cluster", 8, 65536)
    # a part that an even split would leave ragged needs a larger cluster or none
    assert groupnorm.gn_plan(3 * 4, 4, 4).cluster == 1
    assert groupnorm.gn_plan(65536 // 4 + 4, 4, 4) == groupnorm.GENERAL   # odd vector count


def test_plan_for_reads_the_slab_and_both_addresses():
    n = 2 * 384 * 64 * 64
    buf = torch.zeros(n + 8)
    first = -buf.data_ptr() % 16 // 4                    # floats up to a 16-byte line
    aligned = buf[first:first + n].view(2, 384, 64, 64)
    shifted = buf[first + 1:first + 1 + n].view(2, 384, 64, 64)
    assert aligned.data_ptr() % 16 == 0 and shifted.data_ptr() % 16 == 4
    want = groupnorm.gn_plan(12 * 4096, 4096, 4)
    assert groupnorm.plan_for(aligned, aligned, 32) == want
    assert (want.variant, want.cluster, want.threads) == ("cluster", 4, 512)
    assert groupnorm.plan_for(shifted, aligned, 32) == groupnorm.GENERAL
    assert groupnorm.plan_for(aligned, shifted, 32) == groupnorm.GENERAL


def test_gn_variant_counters_reset_with_the_launch_counters():
    groupnorm.variant_launches["cluster"] = 3
    groupnorm.variant_launches["general"] = 2
    groupnorm.variant_launches["nhwc"] = 4
    ops.reset_launch_counts()
    assert ops.gn_variant_counts() == {"cluster": 0, "general": 0, "nhwc": 0}
    # a CPU tensor takes the plain version and counts nothing
    ops.gn_adagn_silu(torch.randn(1, 32, 4, 4), torch.ones(32), torch.zeros(32), groups=32)
    assert ops.gn_variant_counts() == {"cluster": 0, "general": 0, "nhwc": 0}


@pytest.mark.parametrize("shape,bm,warps,r,blocks", [
    ((8, 4, 64, 128), 16, 8, 2, 128), ((8, 4, 256, 32), 32, 8, 1, 256),
    ((32, 4, 64, 128), 32, 8, 4, 256), ((32, 4, 256, 32), 64, 8, 2, 512)])
def test_attention_plan_at_the_path_shapes(shape, bm, warps, r, blocks):
    b, h, t, d = shape
    plan = attention.attention_plan(b * h, t, d, 4)
    assert plan == (bm, 64, warps, r, blocks,
                    attention.attention_smem_bytes(t, d, 4, bm, 64), False)
    assert plan.blocks >= attention.FULL_WAVE            # no SM without a block
    assert 2 * plan.smem_bytes <= attention.SMEM_LIMIT   # two blocks fit an SM
    # every thread of the w.v sweep has an item, none more than two
    items = plan.bm // plan.r * (d // 4)
    assert 32 * plan.warps <= items <= 2 * 32 * plan.warps


@pytest.mark.parametrize("shape,bm,blocks", [
    ((8, 4, 64, 128), 16, 128), ((8, 4, 256, 32), 16, 512),
    ((32, 4, 64, 128), 16, 512), ((32, 4, 256, 32), 32, 1024)])
def test_bf16_path_shapes_go_to_the_tensor_core_kernel(shape, bm, blocks):
    b, h, t, d = shape
    plan = attention.attention_plan(b * h, t, d, 2)
    assert plan == (bm, 64, 4, 0, blocks, attention.attention_mma_smem_bytes(t, d, bm), True)
    assert plan.blocks >= attention.FULL_WAVE
    assert 2 * plan.smem_bytes <= attention.SMEM_LIMIT


@pytest.mark.parametrize("d,mma", [(32, True), (64, True), (128, True), (16, False),
                                   (48, False), (256, False)])
def test_the_tensor_core_kernel_takes_bf16_at_its_head_dims_alone(d, mma):
    assert attention.attention_plan(32, 64, d, 2).mma is mma
    assert attention.attention_plan(32, 64, d, 4).mma is False
    # its score rows are padded to 32 columns plus 8, its Q/K/V rows by 16 bytes
    assert (attention.attention_mma_smem_bytes(64, 128, 16)
            == 16 * (136 * 2 + 4 * 72) + 2 * 64 * 136 * 2)


@pytest.mark.parametrize("t", [1, 16, 50, 64, 77, 256, 1000, 1024])
@pytest.mark.parametrize("d", [8, 32, 36, 64, 128, 200, 256])
@pytest.mark.parametrize("elt", [4, 2])
def test_attention_fits_a_block_up_to_the_tpu_kernels_limits(t, d, elt):
    if (d * elt) % 16:
        with pytest.raises(ValueError, match="16 bytes"):
            attention.attention_plan(4, t, d, elt)
        return
    for bh in (1, 32, 4096):
        plan = attention.attention_plan(bh, t, d, elt)
        assert plan.smem_bytes <= attention.SMEM_LIMIT == 232448
        assert plan.blocks == -(-t // plan.bm) * bh
        if plan.mma:
            assert plan.bm in attention.MMA_ROWS and (plan.bn, plan.warps) == (64, 4)
            continue
        assert (plan.bm, plan.warps) in attention.TILINGS + attention.TILINGS_32_KEYS
        assert plan.bn == (64 if d * elt <= 512 else 32)
        assert plan.r in attention.BUILT[elt][(plan.bm, plan.bn, plan.warps)]
        assert plan.bm // plan.r * (d // 4) <= 2 * 32 * plan.warps


@pytest.mark.parametrize("elt", [4, 2])
def test_every_plan_is_built_and_every_built_tiling_is_some_shapes_plan(elt):
    """Over every D the kernel takes, at grids from one block to thousands:
    the CUDA-core plans are exactly the source's instantiations."""
    asked = set()
    for d in range(16 // elt, attention.MAX_D + 1, 16 // elt):
        for t in (16, 64, 256, 1024):
            for bh in (1, 16, 128, 1024, 8192):
                plan = attention.attention_plan(bh, t, d, elt)
                if not plan.mma:
                    asked.add((plan.bm, plan.bn, plan.warps, plan.r))
    built = {(*tiling, r) for tiling, rows in attention.BUILT[elt].items() for r in rows}
    assert asked == built


def test_the_source_builds_the_tilings_the_wrapper_lists():
    source = os.path.join(os.path.dirname(attention.__file__), "..", "csrc", "attention.cu")
    with open(source) as f:
        lines = re.findall(r"^  PDAE_TILING\((\w+), (\d+), (\d+), (\d+), (\d+)\);$",
                           f.read(), re.M)
    in_source = {(4 if typ == "float" else 2, *map(int, dims)) for typ, *dims in lines}
    listed = {(elt, *tiling, r) for elt, tilings in attention.BUILT.items()
              for tiling, rows in tilings.items() for r in rows}
    assert len(lines) == len(in_source) == 16 and in_source == listed


@pytest.mark.parametrize("d,r", [(8, 1), (16, 1), (48, 1), (200, 2), (256, 4)])
def test_bf16_off_the_tensor_core_head_dims_takes_the_smallest_tile(d, r):
    for bh in (1, 4096):
        plan = attention.attention_plan(bh, 256, d, 2)
        assert (plan.bm, plan.bn, plan.warps, plan.r, plan.mma) == (8, 64, 4, r, False)


def test_attention_shared_memory_does_not_grow_with_t_times_d():
    """Doubling T adds the score rows' bytes and nothing of D; doubling D adds
    the query rows' and the ring's and nothing of T."""
    base = attention.attention_smem_bytes(512, 64, 4, 16, 64)
    assert attention.attention_smem_bytes(1024, 64, 4, 16, 64) - base == 16 * 512 * 4
    assert (attention.attention_smem_bytes(512, 128, 4, 16, 64) - base
            == 16 * 64 * 4 + attention.RING_STAGES * 64 * 64 * 4)
    # one K tile and one V tile need two ring slots, not three
    assert (attention.attention_smem_bytes(64, 128, 4, 16, 64)
            == 4 * 16 * (128 + 68) + 2 * 64 * (128 * 4 + 16))


@pytest.mark.parametrize("t,d", [(0, 64), (1025, 64), (64, 257), (64, 0)])
def test_attention_plan_refuses_what_the_tpu_kernel_refuses(t, d):
    with pytest.raises(ValueError, match="outside"):
        attention.attention_plan(4, t, d, 4)


def test_a_small_grid_takes_the_smallest_tile():
    plan = attention.attention_plan(3, 16, 16, 4)
    assert (plan.bm, plan.warps, plan.blocks) == (8, 4, 6)
    # with 32-key tiles (rows over 512 bytes) only the 8- and 16-row tiles exist
    assert attention.attention_plan(64, 1024, 256, 4)[:3] == (16, 32, 4)


# (channels, H=W, AdaGN and z, dx, launches) of every GN chain of the b32 train
# step that runs a backward: the shift branch's ResBlocks have AdaGN and z, the
# trunk's have neither, and one chain's input needs no gradient
GN_BWD_CHAINS = [
    (384, 64, False, True, 1), (256, 64, False, True, 2), (256, 64, True, True, 1),
    (128, 64, False, True, 1), (128, 64, True, True, 3), (512, 32, False, True, 2),
    (384, 32, False, True, 1), (256, 32, False, True, 1), (256, 32, True, True, 4),
    (768, 16, False, True, 1), (512, 16, False, True, 2), (512, 16, True, True, 1),
    (1024, 8, False, True, 2), (256, 16, False, True, 1), (256, 16, True, True, 3),
    (64, 32, False, True, 1), (768, 8, False, True, 1), (128, 16, False, True, 1),
    (128, 8, False, True, 1), (128, 4, False, True, 1), (512, 8, False, False, 1),
    (512, 8, False, True, 2), (512, 8, True, True, 5)]


def test_the_train_step_has_23_backward_combinations_and_39_launches():
    combos = [chain[:4] for chain in GN_BWD_CHAINS]
    assert len(combos) == len(set(combos)) == 23
    assert sum(chain[4] for chain in GN_BWD_CHAINS) == 39


@pytest.mark.parametrize("channels,side,adagn_z,need_dx,launches", GN_BWD_CHAINS)
@pytest.mark.parametrize("elt", [4, 2])
def test_every_train_step_backward_goes_to_the_cluster_variant(channels, side, adagn_z,
                                                               need_dx, launches, elt):
    hw = side * side
    n = channels // GROUPS * hw
    pair = 2 * n * elt                                   # x and g of one slab
    plan = groupnorm_train.gn_bwd_plan(n, hw, elt, need_dx)
    assert plan.variant == "cluster"
    assert plan.cluster in groupnorm.CLUSTER_SIZES
    assert plan.cluster * plan.part_bytes == pair        # an even split, read once
    assert plan.part_bytes % 32 == 0                     # each half 16-byte vectors
    assert plan.part_bytes <= groupnorm_train.PAIR_BYTES == 65536
    assert 32 <= plan.threads <= groupnorm_train.MAX_THREADS == 256
    assert plan.threads & (plan.threads - 1) == 0
    assert (plan.threads - 32) * 16 < plan.part_bytes // 2   # no warp without a vector
    # a thread per 128 bytes of the pair: half as many threads would not do
    per = groupnorm_train.BYTES_PER_THREAD
    assert plan.threads * per >= plan.part_bytes or plan.threads == 256
    assert plan.threads == 32 or plan.threads // 2 * per < plan.part_bytes
    # the smallest cluster that fits: half as many blocks would not
    assert plan.cluster == 1 or pair // (plan.cluster // 2) > groupnorm_train.PAIR_BYTES
    # the forward's rule for the split, applied to the pair
    assert plan.cluster == groupnorm.cluster_plan(
        n, elt, groupnorm_train.PAIR_BYTES // 2, groupnorm_train.MAX_THREADS).cluster


@pytest.mark.parametrize("kwargs", [
    dict(n=12 * 4096, hw=4096, elt=4, need_dx=True, x_ptr=4),     # x 4 bytes off
    dict(n=12 * 4096, hw=4096, elt=4, need_dx=True, g_ptr=8),     # g 8 bytes off
    dict(n=12 * 4096, hw=4096, elt=2, need_dx=True, dx_ptr=2),    # dx 2 bytes off
    dict(n=12 * 4096, hw=4096, elt=4, need_dx=False, x_ptr=12),
    dict(n=2 * 9, hw=9, elt=4, need_dx=True),                     # H*W no multiple of 4
    dict(n=4 * 12, hw=12, elt=2, need_dx=True),                   # ... of 8 in bf16
    dict(n=2 * 384 * 384, hw=384 * 384, elt=4, need_dx=True),     # over 8 parts
    dict(n=2 * 384 * 384, hw=384 * 384, elt=4, need_dx=False),
    dict(n=256 * 16, hw=16, elt=4, need_dx=True),                 # 256 channels a group
], ids=["x_misaligned", "g_misaligned", "dx_misaligned", "x_misaligned_no_dx",
        "ragged_fp32", "ragged_bf16", "oversized", "oversized_no_dx", "too_many_channels"])
def test_what_the_backward_cluster_variant_does_not_take_goes_to_the_general_one(kwargs):
    assert groupnorm_train.gn_bwd_plan(**kwargs) == groupnorm.GENERAL


@pytest.mark.parametrize("elt,hw,cluster", [(4, 144, 1), (2, 144, 1), (4, 32768, 8),
                                            (2, 32768, 4)])
def test_backward_edge_slabs_that_the_cluster_variant_takes(elt, hw, cluster):
    """H*W = 144 (12x12, no power of two) and a two-channel slab of 32K
    elements a row, which takes a cluster of 8 in fp32."""
    plan = groupnorm_train.gn_bwd_plan(2 * hw, hw, elt, True)
    assert (plan.variant, plan.cluster) == ("cluster", cluster)


@pytest.mark.parametrize("elt,cluster,part", [(4, 8, 131072), (2, 8, 65536)])
def test_a_slab_pair_over_8_standard_parts_takes_larger_parts(elt, cluster, part):
    """FFHQ128's 256-channel concat at 128x128 (8 channels a group): in fp32
    the x and g pair is 1 MB, over 8 parts of PAIR_BYTES, so each of 8
    blocks holds 128 KB of it (at most MAX_PAIR_BYTES, the source's limit);
    in bf16 the 512 KB pair takes the standard parts."""
    hw = 128 * 128
    plan = groupnorm_train.gn_bwd_plan(8 * hw, hw, elt, True)
    assert (plan.variant, plan.cluster, plan.part_bytes) == ("cluster", cluster, part)
    assert plan.part_bytes <= groupnorm_train.MAX_PAIR_BYTES == 196608
    assert plan.threads == groupnorm_train.MAX_THREADS


@pytest.mark.parametrize("channels,side,cluster,threads", [
    (384, 64, 8, 256), (256, 64, 4, 256), (128, 64, 2, 256), (384, 32, 2, 256),
    (256, 32, 1, 256), (512, 16, 1, 256), (1024, 8, 1, 128), (512, 8, 1, 64),
    (128, 8, 1, 32), (128, 4, 1, 32)])
def test_backward_plan_at_the_measured_shapes(channels, side, cluster, threads):
    """fp32: the launches of the rule that made the train step's sum the
    least in the sweep on the card (the fastest launch at each 64x64 slab)."""
    plan = groupnorm_train.gn_bwd_plan(channels // GROUPS * side * side, side * side, 4, True)
    assert (plan.cluster, plan.threads) == (cluster, threads)


def test_backward_plan_for_reads_the_three_addresses():
    n = 2 * 384 * 64 * 64
    buf = torch.zeros(n + 8)
    first = -buf.data_ptr() % 16 // 4
    aligned = buf[first:first + n].view(2, 384, 64, 64)
    shifted = buf[first + 1:first + 1 + n].view(2, 384, 64, 64)
    want = groupnorm_train.gn_bwd_plan(12 * 4096, 4096, 4, True)
    assert groupnorm_train.plan_for(aligned, aligned, aligned, 32) == want
    assert (want.variant, want.cluster) == ("cluster", 8)
    for args in ((shifted, aligned, aligned), (aligned, shifted, aligned),
                 (aligned, aligned, shifted)):
        assert groupnorm_train.plan_for(*args, 32) == groupnorm.GENERAL
    # without dx only x and g count
    assert groupnorm_train.plan_for(aligned, aligned, None, 32) == \
        groupnorm_train.gn_bwd_plan(12 * 4096, 4096, 4, False)


def test_gn_bwd_variant_counters_reset_with_the_launch_counters():
    groupnorm_train.variant_launches["cluster"] = 3
    groupnorm_train.variant_launches["general"] = 1
    groupnorm_train.variant_launches["nhwc"] = 2
    ops.reset_launch_counts()
    assert ops.gn_bwd_variant_counts() == {"cluster": 0, "general": 0, "nhwc": 0}
    # a CPU tensor takes the plain backward and counts nothing
    x = torch.randn(1, 32, 4, 4, requires_grad=True)
    ops.gn_adagn_silu(x, torch.ones(32), torch.zeros(32), groups=32).sum().backward()
    assert ops.gn_bwd_variant_counts() == {"cluster": 0, "general": 0, "nhwc": 0}


@pytest.mark.parametrize("edited", ["source", "header"])
def test_library_name_follows_its_source_and_the_headers(tmp_path, monkeypatch, edited):
    from pdae_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("not a header\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = _build._library_path("k.cu")
    (tmp_path / "notes.txt").write_text("edited\n")
    assert _build._library_path("k.cu") == before
    (tmp_path / ("k.cu" if edited == "source" else "h.cuh")).write_text("// v2\n")
    after = _build._library_path("k.cu")
    assert after != before and os.path.dirname(after) == _build.BUILD_DIR


@pytest.mark.parametrize("source", ["groupnorm.cu", "groupnorm_bwd.cu"])
def test_nhwc_variants_share_one_header(source):
    from pdae_torch.ops import _build

    with open(os.path.join(_build.CSRC, "gn_nhwc.cuh")) as f:
        header = f.read()
    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    assert text.count('#include "gn_nhwc.cuh"') == 1
    for definition in ("void load_frag(", "void store_frag(", "void column_totals(",
                       "float4 table_entry(", "struct NhwcPlan {", "bool nhwc_plan_ok(",
                       "int launch_clusters("):
        assert definition in header and definition not in text, definition
