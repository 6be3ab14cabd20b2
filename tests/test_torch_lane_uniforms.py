"""The one-launch draw of every lane's uniforms (``ops/lane_uniforms.py``)
and device mode's use of it (``device._Segment``), on the CPU.

The kernel runs on the card only (``tests_torch_cuda/
test_torch_cuda_lane_uniforms.py`` holds it to ``torch.rand``'s bits);
here:

* the plan's layout against ATen's ``calc_execution_policy``, worked out
  by hand at the H100's 132 SMs of 2,048 threads: blocks and offset
  steps per sheet, the sheets of a flagship segment in their generators'
  order, their offsets, slots and output views;
* the plain twin: curand's Philox4x32-10 against Random123's known
  answers, and its layout on small shapes against an element-by-element
  reading of ATen's grid-stride loop;
* a segment with a plan, on the CPU through the twin, lands the rows
  that its sheets give the sampler and the TPE step; a segment without
  one (the CPU's) still draws from its generators, seeded with ``seed %
  2**32``;
* the counters: ``device.lane_draws`` and its registry twin, the launch
  counts of the draw.
"""

import numpy as np
import pytest
import torch

import hyperopt_tpu_torch as ht
from hyperopt_tpu_torch import device, tpe
from hyperopt_tpu_torch.obs import metrics
from hyperopt_tpu_torch.ops import lane_uniforms as lu
from hyperopt_tpu_torch.space import compile_space
from test_torch_device import _no_host_round_trips
from test_torch_tpe import flagship

CPU = "cpu"
# An H100's SMs and threads per SM, as ATen reads them.
H100 = (132, 2048)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _s64(x):
    return x - (1 << 64) if x >= 1 << 63 else x


# Random123's known answers for philox4x32_10: (counter words, key words,
# output words).
_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


@pytest.mark.parametrize("ctr, key, expected", _KAT, ids=["zero", "ones",
                                                          "pi"])
def test_philox_known_answers(ctr, key, expected):
    c = torch.tensor([_s64(ctr[0] | ctr[1] << 32)])
    s = torch.tensor([_s64(ctr[2] | ctr[3] << 32)])
    words = lu.philox4x32_10(c, s, _s64(key[0] | key[1] << 32))
    assert tuple(int(w) for w in words) == expected
    # A key given as an int64 tensor reads the same bits.
    words = lu.philox4x32_10(c, s, torch.tensor(_s64(key[0] | key[1] << 32)))
    assert tuple(int(w) for w in words) == expected


# numel -> (blocks, offset step) at 132 SMs x 2,048 threads: G = min(
# ceil(numel / 256), 132 * 8 = 1,056); the step is 4 * the passes of
# 4 * 256 * G floats.
@pytest.mark.parametrize("numel, blocks, step", [
    (1, 1, 4), (24, 1, 4), (256, 1, 4), (257, 2, 4), (110_000, 430, 4),
    (270_336, 1056, 4), (310_000, 1056, 4), (1_081_344, 1056, 4),
    (1_081_345, 1056, 8), (5_000_000, 1056, 20)])
def test_grid_and_offset_step_follow_aten(numel, blocks, step):
    assert lu.grid_blocks(numel, *H100) == blocks
    assert lu.offset_step(numel, blocks) == step


def _flagship_segment(n_lanes, n_cand=10_000):
    cs = compile_space(flagship(ht, 50))
    kern = tpe.get_kernel(cs, 64, n_cand, 25, device=CPU)
    seg = device._build_segment(
        cs, kern, device._wrap_objective(
            lambda p: p["u0"] * p["u0"] + torch.abs(p["n0"]), cs),
        20, 0.25, 1.0, n_lanes=n_lanes)
    return cs, kern, seg


def _with_plan(seg, card=H100):
    """The CUDA draw path on a CPU segment: no generators, the plan's
    sheets drawn by the twin."""
    seg.gens = []
    seg._plan_draws(*card)
    return seg


def test_flagship_plan_lays_out_every_lanes_sheets():
    """Three lanes of the flagship space at 10,000 candidates: each lane
    has a startup stream (one sheet per sampler family, ``[1, k]``: one
    block, a step of 4 each) and a TPE stream (31 density columns twice,
    11 lattice columns twice, 12 choices: 1,056, 1,056, 430, 430 and 469
    blocks, one pass each), both read from the lane's seed slot; each
    sheet is the lane's row of the stacked buffer the step reads."""
    lanes = 3
    cs, kern, seg = _flagship_segment(lanes)
    _with_plan(seg)
    assert kern.noise_shapes() == {
        "cont": [((31, 10_000), (31, 10_000)), ((11, 10_000), (11, 10_000))],
        "cat": (12, 10_000)}
    families = [name for name, shape in cs.noise_shapes(1).items()
                if shape[1]]
    widths = [cs.noise_shapes(1)[name][1] for name in families]
    expected = []
    for j in range(lanes):
        expected += [(j, 4 * k, w, 1, seg.su[name][j])
                     for k, (name, w) in enumerate(zip(families, widths))]
        tpe_sheets = [(310_000, 1056, seg.nz["cont"][0][0]),
                      (310_000, 1056, seg.nz["cont"][0][1]),
                      (110_000, 430, seg.nz["cont"][1][0]),
                      (110_000, 430, seg.nz["cont"][1][1]),
                      (120_000, 469, seg.nz["cat"])]
        expected += [(j, 4 * k, numel, grid, buf[j])
                     for k, (numel, grid, buf) in enumerate(tpe_sheets)]
    got = seg.plan.sheets
    assert [s[:4] for s in got] == [e[:4] for e in expected]
    for (*_, out), (*_, buf) in zip(got, expected):
        assert out.data_ptr() == buf.data_ptr() and out.shape == buf.shape
    assert seg.su["uf"].shape[0] == lanes
    assert seg.nz["cat"].shape == (lanes, 12, 10_000)
    assert seg.plan.device == torch.device(CPU)
    # Per lane: one Philox block per float of the startup sheets and of
    # the 110,000-float sheets (430 blocks of 256 threads, 80 of them
    # idle), 270,336 for each 310,000-float sheet (1,056 blocks, the
    # first 39,664 threads landing two floats); 1,024 of them a block.
    start = sum(widths)
    per_lane = start + 2 * 270_336 + 2 * 110_000 + 120_000
    assert seg.plan.philox_blocks == lanes * per_lane
    assert seg.plan.n_blocks == lanes * (
        len(widths) + 2 * 264 + 2 * 108 + 118)


def test_plan_skips_empty_sheets_without_moving_the_offset():
    """An empty sheet (a space without choices draws a ``[0, n]`` cat
    sheet) draws nothing, as ``torch.rand`` of no element does."""
    a, empty, b = torch.empty(5), torch.empty(0, 7), torch.empty(300)
    plan = lu.DrawPlan([(0, [a, empty, b])], *H100)
    assert [s[:4] for s in plan.sheets] == [(0, 0, 5, 1), (0, 4, 300, 2)]


@pytest.mark.parametrize("sheet", [
    torch.empty(4, 6)[:, :3], torch.empty(8, dtype=torch.float64),
    torch.empty(3, device="meta")], ids=["strided", "float64", "device"])
def test_plan_refuses_what_the_kernel_cannot_write(sheet):
    with pytest.raises(ValueError):
        lu.DrawPlan([(0, [torch.empty(3), sheet])], *H100)


@pytest.mark.parametrize("seeds", [
    torch.zeros(2, dtype=torch.int32), torch.zeros(4, dtype=torch.int64)[::2],
    torch.zeros(1, dtype=torch.int64)], ids=["int32", "strided", "short"])
def test_draw_refuses_bad_seeds(seeds):
    plan = lu.DrawPlan([(0, [torch.empty(3)]), (1, [torch.empty(3)])], *H100)
    with pytest.raises(ValueError):
        lu.draw(plan, seeds)


def _expected_sheet(seed, offset, numel, grid):
    """ATen's grid-stride loop read element by element: element ``li``
    is word ``ii`` of virtual thread ``idx``'s Philox block in pass
    ``p``, ``li = idx + p * 4T + ii * T``, ``T = 256 G``."""
    t = lu.BLOCK * grid
    out = []
    for li in range(numel):
        p, r = divmod(li, lu.UNROLL * t)
        ii, idx = divmod(r, t)
        words = lu.philox4x32_10(torch.tensor([offset // 4 + p]),
                                 torch.tensor([idx]), seed)
        out.append(words[ii])
    return lu.to_uniform(torch.cat(out))


@pytest.mark.parametrize("numel, card, offset", [
    (10, (1, 256), 0), (700, (1, 256), 8), (2000, (1, 256), 4),
    (600, (2, 256), 12), (1500, (132, 2048), 0)],
    ids=["one-lane", "three-lanes", "two-passes", "two-blocks", "h100"])
def test_twin_layout_on_small_shapes(numel, card, offset):
    grid = lu.grid_blocks(numel, *card)
    seed = 2 ** 32 - 1
    got = lu.uniform_sheet_reference(seed, offset, numel, grid)
    want = _expected_sheet(seed, offset, numel, grid)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_to_uniform_maps_the_top_word_to_zero():
    """curand's float of the largest word rounds to 1.0, which
    ``torch.rand`` reverses to 0; the smallest word gives 2^-33."""
    u = lu.to_uniform(torch.tensor([0xFFFFFFFF, 0, 0xFFFFFF00, 1 << 31]))
    assert u.tolist() == [0.0, 2.0 ** -33, float(np.float32(0xFFFFFF00 / 2
                                                            ** 32)), 0.5]


def _load_history(cs, seg, n):
    vals, act = cs.sample(n, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    v = vals.numpy()
    loss = np.square(v[:, :2]).sum(1).astype(np.float32)
    seg.load(v, act.numpy(), loss, np.ones(n, bool), loss, limit=64)


def _twin_sheets(plan, seeds, lane):
    """The twin's sheets of ``lane`` from the seeds, in plan order."""
    return [lu.uniform_sheet_reference(int(seeds[slot]) % 2 ** 32, offset,
                                       numel, grid)
            for slot, offset, numel, grid, _ in plan.sheets if slot == lane]


@pytest.mark.parametrize("arm", ["startup", "tpe"])
def test_plan_path_lands_the_rows_its_sheets_give(arm):
    """A CPU segment drawing through a plan (the twin in the kernel's
    place) lands, in each lane, the row that the sampler or the TPE step
    gives for that lane's twin sheets: seeds reach their lanes' slots,
    reduced modulo 2**32, and the sheets reach the arms in order."""
    lanes = 3
    cs, kern, seg = _flagship_segment(lanes, n_cand=64)
    _with_plan(seg)
    n_rows = 0 if arm == "startup" else 40
    _load_history(cs, seg, n_rows)
    hist = [t[:, :kern.n_cap].clone() for t in (seg.hv, seg.ha, seg.hl,
                                                 seg.hok)]
    seeds = [7, 2 ** 32 + 5, 2 ** 31 - 2]
    seg.run([seeds])
    n_start = len(seg.su)
    for j in range(lanes):
        sheets = _twin_sheets(seg.plan, seeds, j)
        if arm == "startup":
            noise = {name: s.view(1, -1) for name, s
                     in zip(seg.su, sheets[:n_start])}
            want = cs.sample(1, noise=noise, device=CPU)[0][0]
        else:
            shapes = kern.noise_shapes()
            it = iter(sheets[n_start:])
            nz = {"cont": [(next(it).view(a), next(it).view(b))
                           for a, b in shapes["cont"]],
                  "cat": next(it).view(shapes["cat"])}
            want = kern._suggest_lanes(
                *(t[j:j + 1] for t in hist), 0.25, 1.0,
                noise=tpe.stack_noise([nz]))[0][0]
        assert torch.equal(seg.hv[j, n_rows], want)
    # The buffers hold the last trial's sheets, bit for bit.
    flat = [t for pair in seg.nz["cont"] for t in pair] + [seg.nz["cat"]]
    got = [seg.su[name][0] for name in seg.su] + [t[0] for t in flat]
    for g, w in zip(got, _twin_sheets(seg.plan, seeds, 0)):
        assert torch.equal(g.reshape(-1), w)


def test_cpu_segment_keeps_its_generators():
    """On the CPU a segment has no plan: each lane draws from its two
    ``torch.Generator``s, seeded with ``seed % 2**32`` before each trial,
    so its rows are those of the same step fed those generators' draws."""
    lanes, n_rows = 2, 40
    seeds = [11, 2 ** 32 + 11]
    cs, kern, seg = _flagship_segment(lanes, n_cand=64)
    assert seg.plan is None and len(seg.gens) == 2 * lanes
    assert all(g.device == torch.device(CPU) for g in seg.gens)
    _load_history(cs, seg, n_rows)
    seg.run([seeds])
    _, _, ref = _flagship_segment(lanes, n_cand=64)
    _load_history(cs, ref, n_rows)
    noises = [kern.draw_noise(torch.Generator().manual_seed(s % 2 ** 32))
              for s in seeds]
    ref.run([seeds], noises=[noises])
    assert torch.equal(seg.hv[:, n_rows], ref.hv[:, n_rows])
    # Both lanes' seeds are equal modulo 2**32: so are their rows.
    assert torch.equal(seg.hv[0, n_rows], seg.hv[1, n_rows])


def test_plan_path_refuses_noises():
    cs, kern, seg = _flagship_segment(1, n_cand=64)
    _with_plan(seg)
    noise = kern.draw_noise(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="CPU only"):
        seg.run([3], noises=[noise])


def test_plan_step_makes_no_host_round_trip():
    cs, kern, seg = _flagship_segment(2, n_cand=64)
    _with_plan(seg)
    _load_history(cs, seg, 40)
    seg.seeds.copy_(torch.tensor([5, 6]))
    with _no_host_round_trips():
        seg._step()
    assert seg.i.tolist() == [41, 41]


def test_counters_move_with_the_draws():
    """``device.lane_draws`` and its registry twin move once a run by the
    trials drawn through a plan; a generator segment leaves them alone;
    the twin's draws are no launches of the kernel."""
    reg = metrics.registry()
    cs, kern, seg = _flagship_segment(2, n_cand=64)
    device.reset_counters()
    lu.reset_launches()
    before = reg.counter("device.lane_draws").value
    seg.run([[1, 2], [3, 4]])
    assert device.lane_draws == 0
    assert reg.counter("device.lane_draws").value == before
    _with_plan(seg)
    seg.run([[1, 2], [3, 4], [5, 6]])
    assert device.lane_draws == 3
    assert reg.counter("device.lane_draws").value == before + 3
    assert (lu.draw.launches, lu.draw.recorded_by) == (0, 0)
    device.reset_counters()
    assert device.lane_draws == 0
