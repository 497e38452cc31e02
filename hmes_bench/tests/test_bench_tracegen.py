"""The frozen generator draws the program's traces, request for request;
a configuration's own recipe draws the table's traces where it copies a
row, in the configuration's page size, and past the table's largest
footprint without a tensor of the footprint's size."""
import json
import pathlib
import time

import pytest
import torch

from hmes_bench import discover, harness, tracegen, tracegen_large

SEEDS = (0, 7, 2 ** 31 + 5, 4 * (2 ** 31 + 5) + 3)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(tracegen.WORKLOADS))
def test_frozen_generator_equals_program(name, seed):
    from repro_torch.trace.generators import generate
    from repro_torch.trace.workloads import workload_spec
    ours = tracegen.generate(tracegen.workload_spec(name, scale=1e-9,
                                                    seed=seed))
    theirs = generate(workload_spec(name, scale=1e-9, seed=seed))
    assert len(ours.page) == 2048
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_recipe_table_equals_program():
    from repro_torch.trace.workloads import WORKLOADS
    assert {k: vars(v) for k, v in tracegen.WORKLOADS.items()} == \
        {k: vars(v) for k, v in WORKLOADS.items()}


@pytest.mark.parametrize("scale,n", [(1e-4, 1342177), (1e-5, 970662)])
def test_cells_request_counts(scale, n):
    name = "520.omnetpp" if scale == 1e-4 else "505.mcf"
    assert tracegen.workload_spec(name, scale=scale).n_requests == n


# --- recipes in the configuration, page sizes, footprints past the table --

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


def recipe_of(name: str) -> dict:
    """The table row ``name`` written as a configuration's recipe."""
    w = vars(tracegen.WORKLOADS[name])
    return dict({k: v for k, v in w.items() if k != "name"}, source=name)


def config_of(trace: dict, requests: int, page_size: int = 4096) -> dict:
    return {"platform": {"page_size": page_size}, "trace": trace,
            "requests": requests}


def same(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(tracegen.WORKLOADS))
def test_recipe_copying_a_table_row_draws_its_traces(name, seed):
    cfg = config_of({"recipe": recipe_of(name), "scale": 1e-9}, 2048)
    ours = harness.make_traces(cfg, {"traces": 1}, seed)[0]
    table = tracegen.generate(tracegen.workload_spec(name, scale=1e-9,
                                                     seed=seed))
    assert same(ours, table)


@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_cells_traces_equal_the_programs_generator(cell):
    """What every cell draws, against the program's own generator at the
    parent's arguments (4 KiB pages, the table by name)."""
    from repro_torch.trace.generators import generate
    from repro_torch.trace.workloads import workload_spec
    bench = discover.load_benchmark(ROOT)
    w = discover.cell(bench, cell)
    cfg = discover.config(ROOT, bench, w["config"])
    traffic = discover.traffic(ROOT, w["traffic"])
    k, seed = traffic["traces"], 2 ** 31 + 11
    ours = harness.make_traces(cfg, traffic, seed, count=2)
    for i, t in enumerate(ours):
        want = generate(workload_spec(cfg["trace"]["workload"],
                                      scale=cfg["trace"]["scale"],
                                      seed=k * seed + i))
        assert same(t, want)


def test_both_forms_or_neither_is_refused():
    both = {"workload": "505.mcf", "recipe": recipe_of("505.mcf"),
            "scale": 1e-9}
    for trace in (both, {"scale": 1e-9}):
        with pytest.raises(ValueError, match="exactly one"):
            harness.make_traces(config_of(trace, 2048), {"traces": 1}, 1)
    bad = dict(recipe_of("505.mcf"), alpha=0.9)
    with pytest.raises(ValueError, match="recipe"):
        harness.make_traces(config_of({"recipe": bad, "scale": 1e-9}, 2048),
                            {"traces": 1}, 1)


@pytest.mark.parametrize("form", ["workload", "recipe"])
@pytest.mark.parametrize("page_size", [1024, 65536, 2 ** 21])
def test_offsets_lie_inside_the_configurations_page(form, page_size):
    trace = ({"workload": "520.omnetpp"} if form == "workload" else
             {"recipe": recipe_of("520.omnetpp")})
    cfg = config_of(dict(trace, scale=1e-9), 2048, page_size)
    t = harness.make_traces(cfg, {"traces": 1}, 5)[0]
    assert int(t.offset.min()) >= 0 and int(t.offset.max()) < page_size
    assert bool((t.offset % 64 == 0).all())
    assert int(t.offset.max()) >= page_size // 2      # the whole page used
    pages = tracegen.WORKLOADS["520.omnetpp"].footprint_bytes // page_size
    assert int(t.page.max()) < pages


@pytest.mark.parametrize("alpha", [0.9, 1.0, 1.3])
def test_large_sampler_follows_zipf(alpha):
    """Rank frequencies at a footprint of 2^20, 400,000 draws: each of the
    first 32 ranks, and each power-of-two band of ranks, within 5 standard
    deviations (binomial) of Zipf(alpha)'s count."""
    f, n = 2 ** 20, 400_000
    ranks = tracegen_large.zipf_ranks(torch.Generator().manual_seed(3), n, f,
                                      alpha)
    assert int(ranks.min()) >= 0 and int(ranks.max()) < f
    p = torch.arange(1, f + 1, dtype=torch.float64) ** -alpha
    p /= p.sum()
    got = torch.bincount(ranks, minlength=f).double()
    bands = [(k, k + 1) for k in range(32)] + [
        (2 ** b, 2 ** (b + 1)) for b in range(5, 20)]
    for lo, hi in bands:
        q = float(p[lo:hi].sum())
        want, sd = n * q, (n * q * (1 - q)) ** 0.5
        assert abs(float(got[lo:hi].sum()) - want) <= 5 * sd, (lo, hi)


@pytest.mark.parametrize("footprint", [2 ** 20, 2 ** 20 - 3, 12_345, 1, 2])
def test_pages_are_a_bijection_of_ranks(footprint):
    keys = torch.randint(0, 1 << 32, (tracegen_large.FEISTEL_ROUNDS,),
                         generator=torch.Generator().manual_seed(7)).tolist()
    pages = tracegen_large.scatter(torch.arange(footprint), footprint, keys)
    assert torch.equal(pages.sort().values, torch.arange(footprint))
    if footprint > 2:
        assert not torch.equal(pages, torch.arange(footprint))


def test_huge_footprint_comes_back_in_seconds(monkeypatch):
    """4,096 requests over 2^31 - 1 pages: the table's draw would build a
    17 GB CDF; this one draws from the requests alone."""
    def refuse(*a, **kw):
        raise AssertionError("the footprint-sized draw was called")
    monkeypatch.setattr(tracegen, "_zipf_pages", refuse)
    spec = tracegen.TraceSpec(n_requests=4096, footprint_pages=2 ** 31 - 1,
                              zipf_alpha=0.9, seed=2 ** 31 + 5)
    t0 = time.perf_counter()
    t = tracegen_large.generate(spec)
    assert time.perf_counter() - t0 < 30
    assert t.page.dtype == torch.int32 and int(t.page.min()) >= 0
    assert len(t.page.unique()) > 1000          # spread, not clustered
    assert same(t, tracegen_large.generate(spec))


@pytest.mark.parametrize("pattern", ["zipfian", "mixed"])
def test_recipe_past_the_table_draws_its_traces(monkeypatch, pattern):
    """A configuration whose recipe's footprint passes the table's largest
    (4 x 10^8 pages of 4 KiB) draws its 16 traces through
    ``make_traces`` without the footprint-sized draw; its pages reach past
    the first 50 million."""
    monkeypatch.setattr(tracegen, "_zipf_pages", None)
    pages = 4 * 10 ** 8
    recipe = {"source": "a test", "footprint_bytes": pages * 4096,
              "total_traffic_bytes": 2048 * 64e9, "write_frac": 0.3,
              "pattern": pattern, "zipf_alpha": 0.99, "seq_frac": 0.5}
    cfg = config_of({"recipe": recipe, "scale": 1e-9}, 2048)
    traces = harness.make_traces(cfg, {"traces": 16}, 2 ** 31 + 1)
    assert len(traces) == 16
    assert not same(traces[0], traces[1])
    for t in traces:
        assert int(t.page.min()) >= 0 and int(t.page.max()) < pages
        assert int(t.page.max()) >= 50_000_000
