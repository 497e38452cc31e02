"""The port's MoE, MLA, RWKV6 and Hymba pieces against the JAX package's,
on the CPU, where a whole-model comparison (``test_torch_models.py``)
would not say which piece is at fault.

- MoE routing (``moe._top_k_dispatch``) equal to the reference's
  **exactly** (expert indices with ties, gates, slot positions, the keep
  mask) at a capacity that drops tokens; idle decode lanes taking
  capacity from live ones, as in the reference.
- The Hymba ring restack of a prompt longer than the window.
- MLA's absorbed decode against attention over K and V materialised from
  the same latent cache (float64), and its write past ``smax`` dropped.
- The RWKV and Mamba decode states after one step against the chunked
  and sequential prefills over the prompt and that token.

Tolerances: float32 within ``F32_REL`` (1e-5) of the largest magnitude
of each compared tensor, as in ``test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ShardCtx as JShard
from repro.models import moe as j_moe
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import ShardCtx
from repro_torch.models import mla as t_mla
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as TT

from test_torch_models import _close, close_tree, reference

JSH, SH = JShard(), ShardCtx()


def _probs(rng, t, e, ties):
    """Router probabilities [T, E]; with ``ties`` every row holds repeated
    values (a top-k boundary between equal probabilities)."""
    if ties:
        logits = rng.integers(0, 3, (t, e)).astype(np.float32)
    else:
        logits = rng.standard_normal((t, e)).astype(np.float32)
    return np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))


@pytest.mark.parametrize("t, e, k, cap, ties", [
    (40, 8, 2, 6, True), (40, 8, 2, 6, False), (64, 16, 6, 20, True),
    (64, 160, 6, 4, False), (8, 16, 2, 4, True)])
def test_top_k_dispatch_matches_jax_exactly(t, e, k, cap, ties):
    """``idx``, ``gates``, ``pos`` and ``keep`` equal the reference's bit
    for bit, at a capacity that drops tokens (asserted), ties going to
    the lower expert index."""
    probs = _probs(np.random.default_rng(t + e + k), t, e, ties).copy()
    want = j_moe._top_k_dispatch(jnp.asarray(probs), k, cap)
    got = t_moe._top_k_dispatch(torch.from_numpy(probs), k, cap)
    for name, g, w in zip(("idx", "gates", "pos", "keep"), got, want):
        w = np.asarray(w)
        np.testing.assert_array_equal(g.numpy().astype(w.dtype), w,
                                      err_msg=name)
    assert not bool(got[3].all()), "no slot dropped"


def _moe_cfg(arch):
    cfg = TC.get_smoke(arch)
    return cfg, reference(arch)


@pytest.mark.parametrize("arch, lanes, live", [
    ("phi35_moe_42b", 8, 5), ("deepseek_v2_236b", 16, 10)])
def test_idle_moe_lanes_take_capacity_as_in_jax(arch, lanes, live):
    """A decode step's MoE over ``lanes`` lanes, the first ones idle: the
    capacity (``max(4, int(lanes k / E * 1.25))``) is shared by every
    lane, so the idle lanes' tokens push live ones out. The port's output
    and load-balance loss equal the reference's; without the idle lanes
    the live lanes route differently, in both packages."""
    cfg, ref = _moe_cfg(arch)
    jcfg = ref["cfg"]
    p = {k: np.asarray(v[0]) if not isinstance(v, dict) else
         {kk: np.asarray(vv[0]) for kk, vv in v.items()}
         for k, v in ref["params"]["layers"]["mlp"].items()}
    tp = model_params_from_numpy(p, "cpu")
    rng = np.random.default_rng(11)
    x = rng.standard_normal((lanes, 1, cfg.d_model)).astype(np.float32)
    outs = {}
    for n in (lanes, live):        # the idle lanes first, then the live
        xs = x[lanes - n:]
        want, waux = j_moe.moe_block(jcfg, p, jnp.asarray(xs), JSH)
        got, aux = t_moe.moe_block(cfg, tp, torch.from_numpy(xs), SH)
        _close(got, want, what=f"{n} lanes")
        _close(aux, waux, what=f"{n} lanes aux")
        probs = torch.softmax(torch.from_numpy(xs[:, 0]) @ tp["router"], -1)
        keep = t_moe._top_k_dispatch(probs, cfg.moe.top_k,
                                     t_moe.capacity(cfg, n))[3]
        outs[n] = (got[n - live:], keep[n - live:])
    assert not bool(outs[lanes][1].all()), "no live lane's slot dropped"
    assert not torch.equal(outs[lanes][1], outs[live][1])
    assert not torch.allclose(outs[lanes][0], outs[live][0])


def _port(arch):
    ref = reference(arch)
    return ref, TC.get_smoke(arch), model_params_from_numpy(ref["params"],
                                                           "cpu")


def test_hymba_ring_restack_matches_jax():
    """A 12-token prompt through hymba's smoke configuration (window 8,
    local layer 1): the local layer's ring holds positions 4..11, each
    at slot ``position % 8``, equal to the sequence's k/v rows there and
    to the reference's ring; the global layers hold all 12 rows padded
    to ``smax``."""
    ref, cfg, params = _port("hymba_1p5b")
    prompt = torch.from_numpy(ref["prompt"])
    s = prompt.shape[1]
    _, seq, _ = TT.forward_seq(cfg, params, prompt, SH, collect_cache=True)
    _, rings, _ = TT.prefill(cfg, params, prompt, SH, 20)
    sizes = TT.hymba_cache_sizes(cfg, 20)
    assert sizes == (20, 8, 20) and s > cfg.window
    for l, size in enumerate(sizes):
        for name in ("k", "v"):
            ring, rows = rings[l][name], seq[name][l]
            assert ring.shape[2] == size
            if size >= s:
                assert torch.equal(ring[:, :, :s], rows)
                assert not ring[:, :, s:].any()
            else:
                for p in range(s - size, s):
                    assert torch.equal(ring[:, :, p % size], rows[:, :, p])
    close_tree(rings, ref["prefill"][1], what="rings")


def _materialised(cfg, p, x, cache, kv_len):
    """MLA attention of one token over the latent cache with per-head K
    and V materialised (the prefill form), in float64: the absorbed
    form's reference."""
    m = cfg.mla
    h = cfg.n_heads
    f = {k: v.double() for k, v in p.items()}
    cq = x.double() @ f["wq_a"]
    cq = cq * torch.rsqrt((cq * cq).mean(-1, keepdim=True) + cfg.norm_eps) \
        * f["q_norm"]
    q = (cq @ f["wq_b"]).reshape(x.shape[0], h, -1)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    pos = (kv_len - 1).double()
    i = torch.arange(0, m.rope_head_dim, 2, dtype=torch.float64)
    ang = pos[:, None, None] * cfg.rope_theta ** (-i / m.rope_head_dim)
    q1, q2 = q_rope.chunk(2, -1)
    q_rope = torch.cat([q1 * ang.cos() - q2 * ang.sin(),
                        q2 * ang.cos() + q1 * ang.sin()], -1)
    c_kv, k_rope = cache["c_kv"].double(), cache["k_rope"].double()
    k_nope = torch.einsum("bsr,rhn->bhsn", c_kv, f["wk_b"].reshape(
        m.kv_lora_rank, h, m.nope_head_dim))
    v = torch.einsum("bsr,rhn->bhsn", c_kv, f["wv_b"].reshape(
        m.kv_lora_rank, h, m.v_head_dim))
    logits = (torch.einsum("bhn,bhsn->bhs", q_nope, k_nope)
              + torch.einsum("bhr,bsr->bhs", q_rope, k_rope)) * \
        t_mla.scale(cfg)
    s = c_kv.shape[1]
    mask = torch.arange(s)[None, None, :] < kv_len[:, None, None]
    att = torch.where(mask, logits, -torch.inf).softmax(-1)
    o = torch.einsum("bhs,bhsn->bhn", att, v).reshape(x.shape[0], 1, -1)
    return o @ f["wo"]


def test_mla_absorbed_decode_matches_materialised_attention():
    """``mla_decode`` (queries absorbed into the latent space, attention
    over the latents as one head) against attention over per-head K and
    V materialised from the same latent cache in float64, at ragged
    lengths: within ``F32_REL``."""
    _, cfg, params = _port("deepseek_v2_236b")
    p = TT._layer(params, 0)["attn"]
    rng = np.random.default_rng(12)
    b, smax = 3, 16
    x = torch.from_numpy(rng.standard_normal((b, 1, cfg.d_model))
                         .astype(np.float32))
    cache = {"c_kv": torch.from_numpy(rng.standard_normal(
        (b, smax, cfg.mla.kv_lora_rank)).astype(np.float32)),
        "k_rope": torch.from_numpy(rng.standard_normal(
            (b, smax, cfg.mla.rope_head_dim)).astype(np.float32))}
    kv_len = torch.tensor([1, 9, 16], dtype=torch.int32)
    got, _ = t_mla.mla_decode(cfg, p, x, SH, cache, kv_len)
    want = _materialised(cfg, p, x, cache, kv_len)
    _close(got, want, what="absorbed vs materialised")


def test_mla_write_past_smax_is_dropped_as_in_jax():
    """deepseek-v2's smoke decode with lanes at and past ``smax`` (idle
    serving lanes): their latent writes are dropped, as the reference's
    out-of-range scatter is, with no error; logits and the other lanes'
    caches equal the reference's."""
    ref, cfg, params = _port("deepseek_v2_236b")
    jcfg = ref["cfg"]
    rng = np.random.default_rng(13)
    smax = 10
    m = cfg.mla
    cache = {"c_kv": rng.standard_normal((cfg.n_layers, 3, smax,
                                          m.kv_lora_rank)),
             "k_rope": rng.standard_normal((cfg.n_layers, 3, smax,
                                            m.rope_head_dim))}
    cache = {k: v.astype(np.float32) for k, v in cache.items()}
    pos = np.array([4, smax, smax + 7], np.int32)
    toks = rng.integers(0, cfg.vocab, 3).astype(np.int32)
    wl, wc, wp = jax.jit(lambda p, t, c, q: JT.decode_step(
        jcfg, p, t, c, q, JSH))(ref["params"], toks, cache, pos)
    tc = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    lg, tc, tp = TT.decode_step(cfg, params, torch.from_numpy(toks), tc,
                                torch.from_numpy(pos), SH)
    _close(lg, wl, what="logits")
    close_tree(tc, wc, what="cache")
    for k in tc:
        np.testing.assert_array_equal(tc[k][:, 1:].numpy(), cache[k][:, 1:])
        assert not np.array_equal(tc[k][:, 0].numpy(), cache[k][:, 0])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("arch", ["rwkv6_7b", "hymba_1p5b"])
def test_recurrent_decode_state_matches_prefill(arch):
    """Prefill a prompt, decode one more token: the recurrent states
    (RWKV's float32 ``[H, Dk, Dv]`` state and its token-shift inputs;
    Mamba's float32 ``[di, N]`` state and its conv inputs) equal those of
    a prefill over the prompt and that token (the chunked scan, or the
    sequential one), within 1e-5 of their largest magnitude."""
    ref, cfg, params = _port(arch)
    prompt = torch.from_numpy(ref["prompt"])
    tok = torch.from_numpy(ref["steps"][0])
    _, cache, pos = TT.prefill(cfg, params, prompt, SH, 20)
    _, cache, _ = TT.decode_step(cfg, params, tok, cache, pos, SH)
    _, want, _ = TT.prefill(cfg, params, torch.cat([prompt, tok[:, None]],
                                                   1), SH, 20)
    names = (("state", "prev_att", "prev_ffn") if arch == "rwkv6_7b"
             else ("conv", "ssm"))
    if arch == "rwkv6_7b":
        got, want = [cache], [want]
    else:
        got = list(cache)
    for l, (g, w) in enumerate(zip(got, want)):
        for name in names:
            assert g[name].dtype == w[name].dtype
            _close(g[name], w[name], what=f"layer {l} {name}")
    # The state moved: one more token is not the prompt's state.
    _, before, _ = TT.prefill(cfg, params, prompt, SH, 20)
    first = before if arch == "rwkv6_7b" else before[0]
    key = "state" if arch == "rwkv6_7b" else "ssm"
    assert not torch.allclose(first[key], got[0][key])


@pytest.mark.parametrize("arch", ["phi35_moe_42b", "deepseek_v2_236b"])
def test_moe_capacity_follows_the_call(arch):
    """``moe.capacity`` is the reference's formula over the call's tokens
    (``_moe_dense``): a decode step at batch 8 gives both full MoE
    configurations 4 slots an expert, so idle lanes compete for them."""
    for cfg in (TC.get_smoke(arch), TC.get(arch)):
        e = cfg.moe
        for t in (1, 8, 40, 1536):
            assert t_moe.capacity(cfg, t) == max(
                4, int(t * e.top_k / e.n_experts * e.capacity_factor))
    assert t_moe.capacity(TC.get(arch), 8) == 4
