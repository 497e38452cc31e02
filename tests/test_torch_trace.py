"""The port's trace generators: deterministic per seed, pages inside the
footprint, the recipe's write fraction, and the JAX package's
deterministic page streams element for element."""
import numpy as np
import pytest

from repro.trace import generators as j_gen
from repro.trace.workloads import WORKLOADS as J_WORKLOADS

from repro_torch.trace import generators as t_gen
from repro_torch.trace import workloads as t_wl

PATTERNS = ("zipfian", "sequential", "strided", "pointer", "mixed")


def _spec(pattern, seed=0, n=20000):
    return t_gen.TraceSpec(n_requests=n, footprint_pages=1500,
                           write_frac=0.3, pattern=pattern, seed=seed)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_generators_are_deterministic_and_in_range(pattern):
    a = t_gen.generate(_spec(pattern))
    b = t_gen.generate(_spec(pattern))
    c = t_gen.generate(_spec(pattern, seed=1))
    for x, y in zip(a, b):
        assert x.equal(y)
    assert not all(x.equal(y) for x, y in zip(a, c))
    page = a.page.numpy()
    assert a.page.dtype == a.offset.dtype == a.size.dtype
    assert page.min() >= 0 and page.max() < 1500
    off = a.offset.numpy()
    assert off.min() >= 0 and off.max() < 4096 and (off % 64 == 0).all()
    assert (a.size.numpy() == 64).all()
    assert abs(a.is_write.float().mean().item() - 0.3) < 0.02


@pytest.mark.parametrize("pattern", ["sequential", "strided", "pointer"])
def test_deterministic_page_streams_equal_the_jax_package(pattern):
    spec = dict(n_requests=3000, footprint_pages=777, stride_pages=3,
                pattern=pattern, seed=5)
    want = np.asarray(j_gen.generate(j_gen.TraceSpec(**spec)).page)
    got = t_gen.generate(t_gen.TraceSpec(**spec)).page.numpy()
    np.testing.assert_array_equal(want, got)


def test_zipfian_popularity_matches_the_jax_package():
    """Same distribution, different bits: the share of the hottest 1% of
    pages agrees within a few points."""
    spec = dict(n_requests=50000, footprint_pages=2000, pattern="zipfian",
                zipf_alpha=1.0, seed=3)

    def top_share(pages):
        counts = np.bincount(pages, minlength=2000)
        return np.sort(counts)[::-1][:20].sum() / pages.size

    want = top_share(np.asarray(j_gen.generate(j_gen.TraceSpec(**spec)).page))
    got = top_share(t_gen.generate(t_gen.TraceSpec(**spec)).page.numpy())
    assert abs(want - got) < 0.03, (want, got)


def test_workload_table_and_the_main_path_trace_size():
    for name, w in J_WORKLOADS.items():
        assert t_wl.WORKLOADS[name].__dict__ == w.__dict__
    spec = t_wl.workload_spec("520.omnetpp", scale=1e-4)
    assert spec.n_requests == 1_342_177
    assert spec.footprint_pages == 61_696
    assert -(-spec.n_requests // 512) == 2622
    trace, w, n = t_wl.workload_trace("541.leela", scale=1e-7)
    assert n == len(trace) == 2048 and w.name == "541.leela"
