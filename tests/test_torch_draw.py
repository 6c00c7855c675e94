"""The source draws' inverse CDF (``sbayes_tpu_torch/ops/draw.py``) and its
kernel (``csrc/draw.cu``).

On the CPU: CPU tensors take the plain version and never load the kernel
library, the draw's bits and random stream are those of the draw before
the kernel, what the kernel does not take raises, the association of
``csrc/draw.cu``'s prefix sums is a transcription of PyTorch's in-block
scan (``ATen/native/cuda/ScanUtils.cuh``), and ``sbt.draw`` spans nest in
the operators'. Marked ``gpu``, on the card
(``python -m pytest -m gpu tests/test_torch_draw.py``): torch.cumsum's
bits against that association, the kernel bit-equal to the plain version
(C = 2, 3, 4 and 7; one row, odd row counts, over 5M rows; all-zero rows,
NaN rows, ties, uniforms next to 0 and 1; one row at C = 30 to 32, past
two of cub's runs), its launches counted and no
host sync, and 50 steps of a chain batch bit-equal to the same steps with
the plain draw. This file imports no JAX."""
import json
import warnings

import pytest
import torch

from sbayes_tpu_torch.model.math import sample_categorical_onehot
from sbayes_tpu_torch.ops import _cuda, draw


def sklansky_tree(C: int) -> list:
    """The sums ``csrc/draw.cu`` forms for cdf[0..C) (more than one row), as
    trees of unordered pairs: at level s = 2^m every column k with bit m
    set adds the column (k & ~(s - 1)) - 1."""
    buf = [("p", k) for k in range(C)]
    s = 1
    while s < C:
        for k in range(C):
            if k & s:
                buf[k] = frozenset([buf[k], buf[(k & ~(s - 1)) - 1]])
        s <<= 1
    return buf


def torch_scan_tree(C: int, log_num_threads_x: int) -> list:
    """The sums of ``tensor_kernel_scan_innermost_dim_impl`` for one row of C
    columns in a block of 2^log_num_threads_x threads in x, transcribed: two
    values a thread, padded with ``init`` (0), then the Sklansky levels m =
    0..log_num_threads_x, where thread t adds row_buf[si] into row_buf[ti]
    (no level writes what it reads). The first column's ``+ block_total``
    (0 in the first block) is left out: it changes only the sign of a zero."""
    nx = 1 << log_num_threads_x
    buf = [("p", k) if k < C else ("init",) for k in range(2 * nx)]
    for m in range(log_num_threads_x + 1):
        s = 1 << m
        for t in range(nx):
            a = ((t >> m) << (m + 1)) | s
            ti, si = a + t % s, a - 1
            buf[ti] = frozenset([buf[ti], buf[si]])
    return buf[:C]


CUB_ITEMS = 15                     # csrc/draw.cu: kCubItems


def prefix_sums(p, one_row: bool = False):
    """``csrc/draw.cu``'s prefix sums in float32 tensor adds: the Sklansky
    association, or for a tensor of one row cub's: runs of CUB_ITEMS
    folded left to right, each from the totals of the runs before it."""
    cols = list(p.unbind(-1))
    if one_row:
        before = None
        for k0 in range(0, len(cols), CUB_ITEMS):
            run = cols[k0:k0 + CUB_ITEMS]
            total = run[0]
            for c in run[1:]:
                total = total + c
            if before is not None:
                run[0] = before + run[0]
            for k in range(1, len(run)):
                run[k] = run[k - 1] + run[k]
            cols[k0:k0 + CUB_ITEMS] = run
            before = total if before is None else before + total
    else:
        s = 1
        while s < len(cols):
            cols = [c + cols[(k & ~(s - 1)) - 1] if k & s else c for k, c in enumerate(cols)]
            s <<= 1
    return torch.stack(cols, -1)


def edge_inputs(n_rows: int, C: int, seed: int, device="cpu") -> tuple:
    """(p, u) of ``n_rows`` rows cycling through the cases the draw must
    agree on: plain uniforms, magnitudes spread over 2^-40..1, all-zero
    rows, a NaN in a row, ties (equal entries, zeros between), an infinity;
    the uniforms plain, 0, 2^-24, 1 - 2^-24 or exactly at a category's
    boundary."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand(n_rows, C, generator=g)
    kind = torch.arange(n_rows) % 8
    spread = torch.exp2(-40 * torch.rand(n_rows, C, generator=g))
    p = torch.where((kind == 1)[:, None], spread, p)
    p = torch.where((kind == 2)[:, None], torch.zeros_like(p), p)
    col = torch.randint(0, C, (n_rows,), generator=g)
    hit = (kind == 3)[:, None] & (torch.arange(C) == col[:, None])
    p = torch.where(hit, torch.full_like(p, float("nan")), p)
    ties = torch.where(torch.arange(C) % 2 == 1, 0.0, 0.25).expand(n_rows, C)
    p = torch.where((kind == 4)[:, None], ties, p)
    p = torch.where((kind == 5)[:, None], torch.full_like(p, 1.0 / C), p)
    hit = (kind == 6)[:, None] & (torch.arange(C) == col[:, None])
    p = torch.where(hit, torch.full_like(p, float("inf")), p)
    u = torch.rand(n_rows, generator=g)
    which = torch.randint(0, 5, (n_rows,), generator=g)
    cdf = prefix_sums(p.double()).float()
    at_edge = cdf[torch.arange(n_rows), col] / cdf[:, -1]
    u = torch.where(which == 1, 0.0, u)
    u = torch.where(which == 2, 2.0 ** -24, u)
    u = torch.where(which == 3, 1.0 - 2.0 ** -24, u)
    u = torch.where((which == 4) & (at_edge >= 0) & (at_edge < 1), at_edge, u)
    return p.to(device), u.to(device)


def _old_draw(gen, p):
    """The port's draw as it stood before ``ops/draw.py``."""
    c = p.shape[-1]
    cdf = torch.cumsum(p, dim=-1)
    u = torch.rand(p.shape[:-1], generator=gen, device=p.device, dtype=p.dtype) * cdf[..., -1]
    idx = torch.clamp((u[..., None] >= cdf).sum(-1), max=c - 1)
    return idx[..., None] == torch.arange(c, device=p.device)


# ---------------------------------------------------------------------------
# On the CPU.

@pytest.mark.parametrize("C", [1, 2, 3, 4, 7, 32])
def test_cpu_tensors_take_the_plain_draw_and_never_load_the_library(C, monkeypatch):
    """On CPU tensors the draw is the plain version, bit for bit and random
    stream for random stream the draw before the kernel (the same one-hot
    rows and the generator left in the same state); the kernel library is
    never loaded and nothing is counted."""
    def no_library():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(_cuda, "library", no_library)
    draw.launches.reset()
    p, _ = edge_inputs(301, C, seed=C)
    p = p.view(7, 43, C)
    new, old = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    got = sample_categorical_onehot(new, p)
    assert torch.equal(got, _old_draw(old, p))
    assert torch.equal(torch.rand(3, generator=new), torch.rand(3, generator=old))
    assert got.dtype == torch.bool and got.shape == p.shape
    assert torch.equal(got.sum(-1), torch.ones(7, 43, dtype=torch.long))
    assert draw.launches.count == 0


def test_edge_rows_of_the_plain_draw():
    """The cases the kernel is held to, on the plain version: an all-zero row
    takes the last category, a row with a NaN category 0, u = 0 the first
    category with mass, a uniform at a boundary the category above it."""
    p = torch.tensor([[0.0, 0.0, 0.0], [0.2, float("nan"), 0.3], [0.0, 0.0, 2.0],
                      [0.5, 0.0, 0.5], [0.5, 0.0, 0.5]])
    u = torch.tensor([0.7, 0.1, 0.0, 0.5, 0.5 - 2.0 ** -24])
    got = draw.onehot(p, u).to(torch.int64).argmax(-1)
    assert got.tolist() == [2, 0, 2, 2, 0]


def test_max_components_is_the_kernels_and_cubs_runs():
    """``MAX_COMPONENTS`` and ``CUB_ITEMS`` mirror the kernel source, so the
    check refuses what the launch would and the emulation runs the kernel's
    one-row rule."""
    src = (_cuda.SRC_DIR / "draw.cu").read_text()
    assert f"constexpr int kMaxComponents = {draw.MAX_COMPONENTS};" in src
    assert f"constexpr int kCubItems = {CUB_ITEMS};" in src
    assert f"SBT_DRAW_CASE({draw.MAX_COMPONENTS})" in src
    assert f"SBT_DRAW_CASE({draw.MAX_COMPONENTS + 1})" not in src
    assert "sbt_draw" in _cuda.SIGNATURES


@pytest.mark.parametrize("C", [2, 15, 16, 30, 31, 32])
def test_one_row_rule_is_the_left_fold_up_to_two_runs(C):
    """The one-row rule is the plain left-to-right fold while the row fits
    in two of cub's runs (C <= 30): the second run starts from the first's
    total, which is the fold so far; from C = 31 the third run starts from
    the two runs' totals added, another association."""
    g = torch.Generator().manual_seed(C)
    p = torch.exp2(-30 * torch.rand(2000, C, generator=g))
    fold = list(p.unbind(-1))
    for k in range(1, C):
        fold[k] = fold[k - 1] + fold[k]
    fold = torch.stack(fold, -1)
    got = prefix_sums(p, one_row=True)
    assert torch.equal(got[:, :30], fold[:, :30])
    if C > 30:
        assert not torch.equal(got[:, 30], fold[:, 30])


@pytest.mark.parametrize("C", list(range(1, 33)))
def test_kernel_association_is_torchs_in_block_scan(C):
    """``csrc/draw.cu``'s rule (column k at level s adds column
    (k & ~(s - 1)) - 1) forms the same sums as a transcription of PyTorch's
    in-block Sklansky scan, for every C it takes and every block width the
    scan may choose (16 to 512 threads in x): the levels above log2(C) add
    only to columns >= C."""
    want = sklansky_tree(C)
    for log_x in range(4, 10):
        assert torch_scan_tree(C, log_x) == want


@pytest.mark.parametrize("C", [1, 2, 3])
def test_association_matches_cpu_cumsum_where_cpu_adds_in_float(C):
    """For C <= 3 both associations in ``csrc/draw.cu`` are p0, p0 + p1,
    (p0 + p1) + p2. PyTorch's CPU cumsum keeps its running sum in float64
    and rounds each output to float32: its bits are the float32 sums up to
    C = 2 (one add of two float32 values rounds the same either way). At
    C = 3 a float64 running sum differs from the float32 sums on some rows,
    so the rule is held against the card's scan (the ``gpu`` test below),
    and here against float64-then-rounded sums where the two must agree."""
    p, _ = edge_inputs(4000, C, seed=11)
    cdf = torch.cumsum(p, -1)
    for one_row in (False, True):
        ours = prefix_sums(p, one_row)
        if C <= 2:
            assert torch.equal(ours.isnan(), cdf.isnan())
            assert torch.equal(ours.nan_to_num(), cdf.nan_to_num())
        else:
            assert torch.equal(ours[..., :2].nan_to_num(), cdf[..., :2].nan_to_num())
            rounded = p.double().cumsum(-1).float()
            assert torch.equal(rounded.nan_to_num(), cdf.nan_to_num())
            same = (ours[..., 2] == cdf[..., 2]) | (ours[..., 2].isnan() & cdf[..., 2].isnan())
            # the rows where the float32 sum is exact in both orders agree
            exact = (p[:, 0] + p[:, 1]).double() == p[:, 0].double() + p[:, 1].double()
            assert same[exact].all()


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


BAD = {
    "p_f64": (TypeError, lambda: (_meta((4, 5, 3), torch.float64), _meta((4, 5)))),
    "u_f64": (TypeError, lambda: (_meta((4, 5, 3)), _meta((4, 5), torch.float64))),
    "p_bf16": (TypeError, lambda: (_meta((4, 5, 3), torch.bfloat16), _meta((4, 5)))),
    "u_shape": (ValueError, lambda: (_meta((4, 5, 3)), _meta((4, 6)))),
    "u_keeps_last_axis": (ValueError, lambda: (_meta((4, 5, 3)), _meta((4, 5, 3)))),
    "too_many_components": (ValueError, lambda: (_meta((4, 33)), _meta((4,)))),
    "no_components": (ValueError, lambda: (_meta((4, 0)), _meta((4,)))),
    "scalar": (ValueError, lambda: (_meta(()), _meta(()))),
    "u_on_cpu": (TypeError, lambda: (_meta((4, 3)), torch.empty(4))),
}


@pytest.mark.parametrize("case", list(BAD))
def test_launch_args_the_kernel_does_not_take_raise(case):
    """The checks made before every launch, on tensors of the meta device
    (shapes and types, no data): a wrong type, shape, device or number of
    components raises."""
    draw.check_launch_args(_meta((4, 5, 3)), _meta((4, 5)))
    draw.check_launch_args(_meta((2, draw.MAX_COMPONENTS)), _meta((2,)))
    error, make = BAD[case]
    with pytest.raises(error):
        draw.check_launch_args(*make())


def test_draw_spans_nest_in_the_operators(tmp_path):
    """Under a profiler every draw of a chunk opens one ``sbt.draw`` span,
    inside the step's ``sbt.op/<operator>`` span; the chunk's bits are those
    of the same chunk without the profiler."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=2)
    data = synthetic_data(n_objects=16, n_features=5, n_states=3, n_families=2, seed=2)
    rt = SamplerRuntime(Model(data, cfg.model, device="cpu"), cfg.mcmc)

    def chunk():
        gen, op_gen = make_generators(3, "cpu")
        states = rt.init_chains(gen, 3)
        return rt.run_chunk(gen, op_gen, states, rt.new_stats(3), 30)

    plain = chunk()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = chunk()
    for a, b in zip(plain, traced):
        for x, y in zip(a, b):
            if x is not None:
                assert torch.equal(x, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    events = events["traceEvents"] if isinstance(events, dict) else events
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    draws = [s for s in spans if s[0] == "sbt.draw"]
    ops = [s for s in spans if s[0].startswith("sbt.op/")]
    inits = [s for s in spans if s[0].startswith("sbt.init/")]
    assert draws and ops
    for s in draws:
        assert any(o[1] <= s[1] and s[2] <= o[2] for o in ops + inits), s


# ---------------------------------------------------------------------------
# On the card.

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("C", list(range(1, 33)))
def test_torch_cumsum_on_the_card_has_the_kernels_association(C):
    """torch.cumsum's bits on the card are ``prefix_sums``'s: the Sklansky
    association on a tensor of many rows (the in-block scan), cub's runs of
    15 on a tensor of one row, on rows whose sums round differently in the
    two orders."""
    dev = _card()
    g = torch.Generator().manual_seed(C)
    p = torch.exp2(-30 * torch.rand(4096, C, generator=g)).to(dev)
    got = torch.cumsum(p, -1)
    assert torch.equal(got, prefix_sums(p))
    for row in range(64):
        one = p[row:row + 1]
        assert torch.equal(torch.cumsum(one, -1), prefix_sums(one, one_row=True)), row


def _assert_kernel_equals_plain(p, u):
    draw.launches.reset()
    got = draw.onehot(p, u)
    want = draw.onehot_plain(p, u)
    torch.cuda.synchronize()
    assert draw.launches.count == 1
    assert got.dtype == torch.bool and got.shape == p.shape
    bad = (got != want).any(-1)
    assert not bad.any(), (p.view(-1, p.shape[-1])[bad.view(-1)][:4],
                           u.view(-1)[bad.view(-1)][:4])


@pytest.mark.gpu
@pytest.mark.parametrize("C", [2, 3, 4, 7])
@pytest.mark.parametrize("n_rows", [1, 7, 1001, 5_000_003])
def test_kernel_equals_plain_on_the_card(C, n_rows):
    """The kernel's one-hot rows are the plain version's bits, at one row
    (cub's scan in the plain version; every edge case one row at a time),
    at odd row counts and above 5M rows, on ``edge_inputs``."""
    dev = _card()
    if n_rows == 1:
        p, u = edge_inputs(96, C, seed=C, device=dev)
        for r in range(96):
            _assert_kernel_equals_plain(p[r:r + 1], u[r:r + 1])
        return
    p, u = edge_inputs(n_rows, C, seed=n_rows + C, device=dev)
    _assert_kernel_equals_plain(p, u)
    if n_rows == 1001:                       # a (B, m, F, C) batch, and a strided view
        _assert_kernel_equals_plain(p[:1000].view(4, 10, 25, C), u[:1000].view(4, 10, 25))
        wide = torch.cat([p, p], -1)[:, ::2]
        assert not wide.is_contiguous()
        _assert_kernel_equals_plain(wide, u)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [30, 31, 32])
def test_one_row_kernel_equals_plain_past_two_cub_runs_on_the_card(C):
    """At one row and C > 30 the plain version's cub scan starts a third run
    of 15 items from the first two runs' totals added: the kernel's draws are
    still the plain version's bits, row by row on ``edge_inputs`` and on rows
    of spread magnitudes with the uniform at each category's boundary."""
    dev = _card()
    p, u = edge_inputs(64, C, seed=C, device=dev)
    g = torch.Generator().manual_seed(C)
    spread = torch.exp2(-30 * torch.rand(64, C, generator=g)).to(dev)
    cdf = prefix_sums(spread, one_row=True)
    at = torch.tensor([min(28 + r % 4, C - 1) for r in range(64)], device=dev)
    edge = (cdf[torch.arange(64, device=dev), at] / cdf[:, -1]).clamp(max=1 - 2 ** -24)
    for rows, us in ((p, u), (spread, edge)):
        for r in range(64):
            _assert_kernel_equals_plain(rows[r:r + 1], us[r:r + 1])


@pytest.mark.gpu
def test_draw_counts_its_launch_and_does_not_sync_on_the_card():
    """``sample_categorical_onehot`` on CUDA tensors launches the kernel once
    (variant C, at the device and stream of the launch) and waits for
    nothing: it runs under ``torch.cuda.set_sync_debug_mode("error")``."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    p = torch.rand(64, 100, 36, 3, device=dev)
    sample_categorical_onehot(gen, p)                                   # builds the library
    torch.cuda.synchronize()
    draw.launches.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = sample_categorical_onehot(gen, p)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert draw.launches.count == 1 and draw.launches.variants == {3: 1}
    place = (dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    assert draw.launches.by_place == {place: {3: 1}}
    assert torch.equal(x.sum(-1), torch.ones(64, 100, 36, dtype=torch.long, device=dev))


@pytest.mark.gpu
def test_wrong_arguments_raise_on_the_card():
    """A CUDA call with a wrong type, shape or device raises before any
    launch."""
    dev = _card()
    p, u = torch.rand(8, 3, device=dev), torch.rand(8, device=dev)
    draw.launches.reset()
    for args, error in (((p.double(), u), TypeError), ((p, u.double()), TypeError),
                        ((p, u[:7]), ValueError), ((p, u.cpu()), TypeError),
                        ((torch.rand(8, 33, device=dev), u), ValueError)):
        with pytest.raises(error):
            draw.onehot(*args)
    assert draw.launches.count == 0


@pytest.mark.gpu
def test_chain_steps_bit_equal_with_the_plain_draw_on_the_card(monkeypatch):
    """The south_america shape (100 x 36 x 6, universal + 6 families) at
    K = 3 with the cost-based geo prior and the default schedule, 64 chains:
    the init and 50 steps end in the same bits, states and statistics, with
    the kernel as with the plain draw patched in; the kernel run launched
    the kernel and never ran the plain version."""
    from sbayes_tpu_torch.model.model import Model
    from sbayes_tpu_torch.sampling.runner import SamplerRuntime, make_generators
    from sbayes_tpu_torch.testing import synthetic_config, synthetic_data

    dev = _card()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg = synthetic_config(n_clusters=3, geo_prior="cost_based")
    rt = SamplerRuntime(Model(synthetic_data(), cfg.model, device=dev), cfg.mcmc)
    plain_calls = []
    plain = draw.onehot_plain

    def counted_plain(p, u):
        plain_calls.append(p.device.type)
        return plain(p, u)

    def run():
        gen, op_gen = make_generators(17, dev)
        states = rt.init_chains(gen, 64)
        return rt.run_chunk(gen, op_gen, states, rt.new_stats(64), 50)

    monkeypatch.setattr(draw, "onehot_plain", counted_plain)
    draw.launches.reset()
    with_kernel = run()
    assert draw.launches.count > 0 and plain_calls == []
    monkeypatch.setattr(draw, "onehot", counted_plain)
    with_plain = run()
    assert plain_calls and set(plain_calls) == {"cuda"}
    for a, b in zip(with_kernel, with_plain):
        for name, x, y in zip(a._fields, a, b):
            if x is not None:
                assert torch.equal(x, y), name
