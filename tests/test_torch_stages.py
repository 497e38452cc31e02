"""The chunk step's stage cut (``kernels.chunk_step.step_until`` over
``STAGES``, ``pipeline_phase(..., upto=)``) and
``core.consistency.reorder_depth``, bit for bit against ``jax.jit`` of the
JAX package's functions on the same numpy-seeded inputs.

Each stage runs the golden scenario of ``test_torch_kernels`` (pins, a
poisoned page, a swap in flight, retirement and a fault plan) chunk
after chunk, each package carrying its own truncated state forward, so
the clock's advance and the pass-through of the retirement registers are
held over several chunks too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
from repro.core import consistency as j_cons
from repro.kernels import chunk_step as jcs

from repro_torch.core import PolicyRegistry
from repro_torch.core import consistency as t_cons
from repro_torch.kernels import chunk_step as tcs
from test_torch_core import POLICIES, T, assert_same, t_params, t_plan, \
    t_state
from test_torch_kernels import _j_scalars, _scenario, _t_scalars

_juntil = jax.jit(jcs.step_until, static_argnums=(0, 1),
                  static_argnames=("upto",))


def test_stages_are_the_reference_stages():
    assert tcs.STAGES == jcs.STAGES


@pytest.mark.parametrize("policy", ["hotness", "write_bias"])
@pytest.mark.parametrize("upto", jcs.STAGES)
def test_step_until_matches_jax(upto, policy):
    cfg_j, cfg_t, js, arrays, jplan = _scenario(policy, n_chunks=5)
    jreg = jcore.PolicyRegistry.snapshot(POLICIES)
    treg = PolicyRegistry.snapshot()
    jp = cfg_j.runtime()
    tp, ts, tplan = t_params(jp), t_state(js), t_plan(jplan)
    cfg_j = cfg_j.with_(policy="hotness")
    jt, jsc, jbf = js.table, _j_scalars(js), js.bank_free
    tt, tsc, tbf = ts.table, _t_scalars(ts), ts.bank_free
    for c in range(len(arrays[0]) // cfg_j.chunk):
        sl = slice(c * cfg_j.chunk, (c + 1) * cfg_j.chunk)
        chunk = [a[sl] for a in arrays]
        jt, jsc, jbf, jo = _juntil(cfg_j, jreg, jt, jp, jsc, jbf,
                                   *map(jnp.asarray, chunk), jplan,
                                   upto=upto)
        tt, tsc, tbf, to = tcs.step_until(cfg_t, treg, tt, tp, tsc, tbf,
                                          *map(T, chunk), tplan, upto=upto)
        assert_same((jt, jsc, jbf, jo), (tt, tsc, tbf, to),
                    f"{upto} {policy} chunk {c}")


def test_step_until_refuses_an_unknown_stage():
    cfg_j, cfg_t, js, arrays, _ = _scenario("hotness", n_chunks=1)
    ts = t_state(js)
    with pytest.raises(ValueError, match="unknown stage"):
        tcs.step_until(cfg_t, PolicyRegistry.snapshot(), ts.table,
                       t_params(cfg_j.runtime()), _t_scalars(ts),
                       ts.bank_free, *map(T, arrays), upto="tx")


@pytest.mark.parametrize("shape", [(64,), (3, 40)])
@pytest.mark.parametrize("seed", [0, 1])
def test_reorder_depth_matches_jax(shape, seed):
    rng = np.random.default_rng(seed)
    complete = rng.integers(-50, 5000, shape).astype(np.int32)
    complete[..., ::7] = np.iinfo(np.int32).min          # idle lanes
    want = jax.jit(j_cons.reorder_depth)(jnp.asarray(complete))
    got = t_cons.reorder_depth(T(complete))
    assert_same(want, got, "reorder_depth")
    assert int(got) > 0
