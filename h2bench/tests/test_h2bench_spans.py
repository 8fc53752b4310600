"""The readers of the program's own spans: the recompression's rank-pick
round trips and regatherings from a hand-made trace summary, the set-up's
stages from a hand-filled span table and from a small cell's real
set-up; each reads None where its span is absent, as on a program that
has no such span, but the count of reads, which reads 0 on a program
that keeps span totals."""
import pytest

from _small import ROOT, small_cell
from h2bench import harness
from h2bench.trace import SHORT_GAP, SpanStat, TraceSummary

CALL = "h2bench/compress-call"
COMPRESS = "compress-2d-exp-4m-tol1e-3"
SETUP = {"setup.kernel_build_s": ["kernels/build"],
         "setup.cluster_tree_s": ["construct/cluster-tree"],
         "setup.block_structure_s": ["construct/block-structure"],
         "setup.kernel_eval_s": ["construct/bases", "construct/coupling",
                                 "construct/dense"],
         "setup.marshal_s": ["construct/marshal"]}


def _read(metric, ctx=None):
    return harness.reader(metric, ROOT / "h2bench")(ctx)


def _ctx(spans, gaps):
    summary = TraceSummary(window_s=0.6, busy_s=0.57, spans=spans,
                           device_ops=[], idle_gaps=gaps, ops=2454)
    return harness.Context(summary, 30.0, 157, {}, {}, CALL)


def _three_calls():
    """Three traced recompressions at depth 16: 35 reads a call, 6.8 ms
    idle after them and 9 ms of regathering a call."""
    return _ctx({CALL: SpanStat(3, 0.56, 2454),
                 "compress/rank-pick": SpanStat(105, 0.0021, 105),
                 "compress/remarshal": SpanStat(6, 0.027, 96)},
                [["compress/rank-pick", 0.0204], [SHORT_GAP, 0.0027]])


@pytest.mark.parametrize("metric,want", [
    ("compress.host_syncs", 35.0),
    ("compress.rank_pick_idle_ms", 6.8),
    ("compress.remarshal_ms", 9.0)])
def test_compress_readers_per_call(metric, want):
    assert _read(metric, _three_calls()) == pytest.approx(want)


def _without_rank_pick():
    return _ctx({CALL: SpanStat(3, 0.56, 2454),
                 "compress/truncate": SpanStat(3, 0.06, 300)},
                [["compress/truncate", 0.0204]])


@pytest.mark.parametrize("metric", ["compress.host_syncs",
                                    "compress.rank_pick_idle_ms",
                                    "compress.remarshal_ms"])
def test_compress_readers_none_without_their_span(monkeypatch, metric):
    """No span: the times read None, and so does the count on a program
    that keeps no span totals (one older than the span); no calls or no
    trace: None."""
    if metric != "compress.host_syncs":
        assert _read(metric, _without_rank_pick()) is None
    no_calls = _ctx({}, [["compress/rank-pick", 0.0204]])
    assert _read(metric, no_calls) is None
    assert _read(metric, harness.Context(None, 30.0, 157, {}, {}, CALL)) \
        is None
    from repro_torch.obs import trace
    monkeypatch.delattr(trace, "span_totals")
    assert _read(metric, _without_rank_pick()) is None


def test_host_syncs_reads_zero_once_nothing_is_read_back():
    """A program with span totals that opened no ``compress/rank-pick``
    in calls of the window read nothing back: 0, not None."""
    assert _read("compress.host_syncs", _without_rank_pick()) == 0


TABLE = {"kernels/build": (6, 0.05), "construct/cluster-tree": (1, 11.5),
         "construct/block-structure": (1, 4.25),
         "construct/bases": (1, 0.5), "construct/coupling": (1, 2.0),
         "construct/dense": (1, 0.75), "construct/marshal": (1, 1.5),
         "compress/rank-pick": (35, 0.01)}


@pytest.mark.parametrize("metric,want", [
    ("setup.kernel_build_s", 0.05), ("setup.cluster_tree_s", 11.5),
    ("setup.block_structure_s", 4.25), ("setup.kernel_eval_s", 3.25),
    ("setup.marshal_s", 1.5)])
def test_setup_readers_from_a_hand_filled_table(monkeypatch, metric, want):
    from repro_torch.obs import trace
    monkeypatch.setattr(trace, "span_totals", lambda: dict(TABLE))
    assert _read(metric) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SETUP))
def test_setup_readers_none_without_their_span(monkeypatch, metric):
    from repro_torch.obs import trace
    others = {k: v for k, v in TABLE.items() if k not in SETUP[metric]}
    monkeypatch.setattr(trace, "span_totals", lambda: others)
    assert _read(metric) is None
    # entered while the table was cleared, then never again
    monkeypatch.setattr(trace, "span_totals", lambda: {
        **others, **{n: (0, 0.0) for n in SETUP[metric]}})
    assert _read(metric) is None
    # a program that keeps no span totals
    monkeypatch.delattr(trace, "span_totals")
    assert _read(metric) is None


def test_setup_readers_read_a_small_cells_construction():
    """A small compress cell's set-up on the CPU: each construction stage
    read once, their sum within the runner's ``construct`` part; no
    kernel build on the CPU."""
    from repro_torch.obs import trace
    cell = small_cell(COMPRESS)
    trace.reset_span_totals()
    runner = cell.runner.Cell(cell.config, cell.traffic, 7, "cpu")
    runner.setup()
    got = {m: _read(m) for m in SETUP}
    assert got.pop("setup.kernel_build_s") is None
    assert all(v is not None and v > 0 for v in got.values()), got
    assert sum(got.values()) <= runner.parts["construct"]
    table = trace.span_totals()
    assert all(table[n][0] == 1 for m in got for n in SETUP[m])
