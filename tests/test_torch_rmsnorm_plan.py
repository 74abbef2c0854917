"""The RMSNorm backward's launch plan (``ops.plan_bwd``), on the CPU.

``plan_bwd`` is a pure function of (rows, D, element size, SM count): it
picks the route of ``rmsnorm.cu``'s backward (``ring``: a group of warps a
row, rows staged in shared memory by bulk copies; ``stripe``: a block a
row, for rows too wide for the ring) and its geometry. The kernel is one
cooperative launch whose dw sum syncs the grid, so every block must fit an
SM at once: these tests hold each plan to the card's shared memory and to
at most two blocks an SM. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""
import pytest

from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ops import BwdPlan
from test_torch_cuda import RMSNORM_BWD_CASES

H100_SMS = 132
SM_COUNTS = [H100_SMS, 114, 16, 1]   # SXM, PCIe, and small cards
ELEM_BYTES = {"float32": 4, "bfloat16": 2}


@pytest.mark.parametrize("args, want", [
    # internlm2-1.8b's train shape: 4 groups of 2 warps a block, 2 stages,
    # each group walking 4 rows
    ((2048, 2048, 2, 132), BwdPlan("ring", 256, 4, 2, 2, 65792, 132)),
    ((2048, 2048, 4, 132), BwdPlan("ring", 512, 4, 4, 2, 131456, 132)),
    # fewer SMs: more rows an SM, so more groups a block
    ((2048, 2048, 2, 114), BwdPlan("ring", 512, 4, 2, 2, 131584, 114)),
    ((2048, 2048, 2, 16), BwdPlan("ring", 512, 4, 2, 2, 131584, 16)),
    # the LM workflow's width: a warp a row, a row a group at a time
    ((4096, 128, 2, 132), BwdPlan("ring", 512, 1, 1, 2, 17152, 132)),
    ((512, 128, 2, 132), BwdPlan("ring", 128, 1, 1, 1, 2176, 128)),
    # few rows: a block a row, one stage
    ((1, 2048, 2, 132), BwdPlan("ring", 64, 4, 2, 1, 8240, 1)),
    ((5, 8, 2, 132), BwdPlan("ring", 32, 1, 1, 1, 64, 5)),
    # wide rows: a group of 4 to 16 warps a row
    ((1000, 2056, 2, 132), BwdPlan("ring", 256, 4, 4, 2, 33088, 132)),
    ((600, 8192, 4, 132), BwdPlan("ring", 512, 4, 16, 2, 131360, 132)),
    ((2, 16384, 2, 132), BwdPlan("ring", 512, 4, 16, 1, 65808, 2)),
    # past 16 warps of 4 vectors: the stripe route
    ((33, 12288, 4, 132), BwdPlan("stripe", 512, 8, 16, 0, 0, 33)),
    ((2, 32768, 2, 132), BwdPlan("stripe", 512, 8, 16, 0, 0, 2)),
], ids=str)
def test_plan_bwd_is_a_function_of_rows_width_element_size_and_sms(args, want):
    assert ops.plan_bwd(*args) == want
    assert ops.plan_bwd(*args) == ops.plan_bwd(*args)


@pytest.mark.parametrize("shape", [(2048, 2048), (512, 128), (4096, 128)],
                         ids=str)
@pytest.mark.parametrize("dtype", list(ELEM_BYTES))
def test_main_path_shapes_take_the_ring(shape, dtype):
    """internlm2-1.8b's train shape and the LM workflow's D 128 rows."""
    for n_sms in SM_COUNTS:
        assert ops.plan_bwd(*shape, ELEM_BYTES[dtype], n_sms).route == "ring"


@pytest.mark.parametrize("dtype", list(ELEM_BYTES))
def test_the_train_shape_keeps_32_kb_of_rows_in_flight_an_sm(dtype):
    e = ELEM_BYTES[dtype]
    p = ops.plan_bwd(2048, 2048, e, H100_SMS)
    groups = p.threads // 32 // p.group
    assert groups * p.stages * 2 * 2048 * e >= 32 * 1024


@pytest.mark.parametrize("shape", RMSNORM_BWD_CASES, ids=str)
@pytest.mark.parametrize("dtype", list(ELEM_BYTES))
def test_every_card_case_gets_a_plan_that_fits_the_card(shape, dtype):
    rows, d = shape
    e = ELEM_BYTES[dtype]
    v = 16 // e
    for n_sms in SM_COUNTS:
        p = ops.plan_bwd(rows, d, e, n_sms)
        assert p.smem <= ops.SMEM_MAX == 227 * 1024
        assert 1 <= p.grid <= 2 * n_sms and p.grid <= rows
        assert p.threads % 32 == 0 and 32 <= p.threads <= ops.MAX_THREADS
        assert p.group & (p.group - 1) == 0 and p.nv & (p.nv - 1) == 0
        if p.route == "ring":
            groups = p.threads // 32 // p.group
            assert p.threads == 32 * groups * p.group
            assert p.grid <= n_sms
            assert 32 * p.group * p.nv * v >= d and p.nv <= ops.RING_VECS
            assert 1 <= p.stages <= ops.RING_MAX_STAGES
            assert p.smem == ops._ring_smem(groups, p.group, p.stages, d, e)
            # a block owns a row at least; a group's slots hold its dw share
            assert (p.grid - 1) * groups < rows
            assert p.stages * 2 * d * e >= 4 * d
            # a named barrier a group of several warps (ids 1..15)
            assert p.group == 1 or groups <= 15
            # bulk copies: rows and slots stay 16-byte aligned
            assert (d * e) % 16 == 0
        else:
            assert p.route == "stripe" and p.stages == 0 and p.smem == 0
            assert p.threads * p.nv * v >= d and p.nv == ops.MAX_BWD_VECS


@pytest.mark.parametrize("rows", [1, 2, 31, 32, 33, 527, 528, 529, 2048, 10_000])
def test_ring_stages_follow_the_rows_a_group_takes(rows):
    """As many stages as the group has rows, up to the ring's depth; the
    grid never wider than the rows need."""
    p = ops.plan_bwd(rows, 128, 2, H100_SMS)
    groups = p.threads // 32 // p.group
    assert p.grid == min(H100_SMS, -(-rows // groups))
    per_group = -(-rows // (p.grid * groups))
    assert p.stages == min(ops.RING_MAX_STAGES, per_group)


@pytest.mark.parametrize("d, elem_bytes", [(16392, 4), (32776, 2), (40000, 2)])
def test_a_row_too_wide_for_both_routes_raises(d, elem_bytes):
    with pytest.raises(ValueError, match="wider"):
        ops.plan_bwd(4, d, elem_bytes, H100_SMS)


@pytest.mark.parametrize("d, elem_bytes", [(16384, 4), (32768, 2)])
def test_the_widest_rows_taken_today_still_plan(d, elem_bytes):
    assert ops.plan_bwd(4, d, elem_bytes, H100_SMS).route == "stripe"


def test_the_phase_cuts_of_the_backward_find_their_places():
    """``launch/rmsnorm_bwd_layouts.py`` times the backward with phases cut
    out of ``rmsnorm.cu``'s ring kernel: each cut still finds its place in
    the source and leaves the other phases and the stripe route whole."""
    from repro_torch.launch import rmsnorm_bwd_layouts as layouts
    src = open(ops.SOURCE).read()
    cuts = layouts._phase_sources()
    assert list(cuts) == ["walk", "walk+partials", "walk+partials+sync",
                          "first rows all at once"]
    at_once = cuts.pop("first rows all at once")
    assert layouts._ALL in at_once and layouts._NEXT not in at_once
    assert at_once.count(layouts._SYNC + layouts._SUM) == 2
    sync, total = layouts._SYNC + layouts._SUM, src.count(layouts._SYNC)
    for name, text in cuts.items():
        assert "rmsnorm_bwd_empty" in text
        ring = text[text.index("rmsnorm_bwd_ring(BwdArgs a) {"):
                    text.index("// The stripe route")]
        assert layouts._SUM not in ring and ("sync" in name) == (
            layouts._SYNC in ring)
        assert ("partials" in name) == ("a.partial + " in ring)
        assert text.count(sync) == src.count(sync) - 1   # the stripe's stays
        assert text.count(layouts._SYNC) == total - ("sync" not in name)
