"""The port's model path against the JAX package's, on the CPU.

Both sides start from the same parameters: ``repro.models.init_params``
drawn by JAX, carried across as numpy arrays by
``repro_torch.convert.model_params_from_numpy``. For each of the ten
smoke configurations (the six dense ones: minitron-8b, phi3-mini,
gemma3-4b with its 8-token window, internlm2, and the two frames
frontends phi3-vision and musicgen; and the four other families:
deepseek-v2's MLA + MoE with shared experts, rwkv6, hymba's attention +
Mamba with its 8-token ring, phi3.5-moe), ``forward_seq``, ``prefill``
(logits and cache) and a teacher-forced run of ``decode_step`` are held
to the reference under ``jax.jit`` in float32 within ``F32_REL`` of the
largest magnitude of each compared tensor (the two sides sum products in
different orders; XLA also fuses multiply-adds). The bfloat16 cases are
held within ``BF16_REL``. The port's decode path is also held to its own
sequence path, and ``layer_windows`` and the configurations to the
reference's. The families' own pieces (MoE routing, the Hymba ring, the
MLA absorbed decode, the recurrent states) have tests of their own in
``test_torch_families.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models import ShardCtx as JShard
from repro.models import chunked_attention as j_ca
from repro.models import decode as j_dec
from repro.models import layers as j_layers
from repro.models import transformer as JT

import repro_torch.configs as TC
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import ShardCtx
from repro_torch.models import chunked_attention as t_ca
from repro_torch.models import decode as t_dec
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as TT

DENSE = ["minitron_8b", "phi3_mini_3p8b", "gemma3_4b", "internlm2_1p8b",
         "phi3_vision_4p2b", "musicgen_medium"]
FAMILIES = ["deepseek_v2_236b", "rwkv6_7b", "hymba_1p5b", "phi35_moe_42b"]
ARCHS = DENSE + FAMILIES
# float32: 1e-5 of the compared tensor's largest magnitude.
F32_REL = 1e-5
# bfloat16 activations: every product and layer output rounds to 8 bits
# of mantissa (one step is 2^-8 to 2^-7 of a value), and the two sides'
# float32 sums round apart before that; 2^-6 of the largest magnitude
# allows a few steps of drift over the smoke model's two layers (measured:
# 2^-7.4 on the prefill logits).
BF16_REL = 2.0 ** -6
B, S, SMAX, STEPS = 2, 12, 20, 4
JSH, SH = JShard(), ShardCtx()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict / tuple tree, dict keys sorted
    (JAX hands dicts back with sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def close_tree(got, want, rel=F32_REL, what=""):
    g, w = list(leaves(got)), list(leaves(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        _close(a, b, rel, what + path)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(clone(v) for v in tree)
    return tree.clone()


def _close(got, want, rel=F32_REL, what=""):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= rel * scale, f"{what}: max|err| {err:.3e} vs {rel * scale:.3e}"


def _inputs(cfg, rng, s, b=B):
    if cfg.frontend == "frames":
        return rng.standard_normal((b, s, cfg.frame_dim)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _step_inputs(cfg, rng, b=B):
    if cfg.frontend == "frames":
        return rng.standard_normal((b, cfg.frame_dim)).astype(np.float32)
    return rng.integers(0, cfg.vocab, (b,)).astype(np.int32)


def _reference(arch, dtype=None):
    """The JAX side of one configuration: params as numpy, the prompt, the
    teacher-forced step inputs and every jitted output."""
    cfg = JC.get_smoke(arch)
    if dtype:
        cfg = cfg.with_(param_dtype=dtype, activation_dtype=dtype)
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    prompt = _inputs(cfg, rng, S)
    steps = [_step_inputs(cfg, rng) for _ in range(STEPS)]
    fwd = jax.jit(lambda p, x: JT.forward_seq(cfg, p, x, JSH,
                                              collect_cache=True))
    pre = jax.jit(lambda p, x: JT.prefill(cfg, p, x, JSH, SMAX))
    dec = jax.jit(lambda p, t, c, q: JT.decode_step(cfg, p, t, c, q, JSH))
    x, cache, aux = fwd(params, prompt)
    logits, c, pos = pre(params, prompt)
    out = {"forward": (x, cache, aux), "prefill": (logits, c, pos), "decode": []}
    for t in steps:
        lg, c, pos = dec(params, t, c, pos)
        out["decode"].append(lg)
    out["final"] = (c, pos)
    return {"cfg": cfg, "params": jax.tree.map(np.asarray, params),
            "prompt": prompt, "steps": steps, **out}


_CACHE = {}


def reference(arch, dtype=None):
    if (arch, dtype) not in _CACHE:
        _CACHE[(arch, dtype)] = _reference(arch, dtype)
    return _CACHE[(arch, dtype)]


def _port_cfg(arch, dtype=None):
    cfg = TC.get_smoke(arch)
    return cfg.with_(param_dtype=dtype, activation_dtype=dtype) if dtype \
        else cfg


def _port_run(arch, dtype=None):
    """The port's side on the reference's parameters and inputs."""
    ref = reference(arch, dtype)
    cfg = _port_cfg(arch, dtype)
    params = model_params_from_numpy(ref["params"], "cpu")
    prompt = torch.from_numpy(ref["prompt"])
    x, cache, aux = TT.forward_seq(cfg, params, prompt, SH,
                                   collect_cache=True)
    logits, c, pos = TT.prefill(cfg, params, prompt, SH, SMAX)
    out = {"forward": (x, cache, aux),
           "prefill": (logits, clone(c), pos), "decode": []}
    for t in ref["steps"]:
        lg, c, pos = TT.decode_step(cfg, params, torch.from_numpy(t), c, pos,
                                    SH)
        out["decode"].append(lg)
    out["final"] = (c, pos)
    return ref, out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_seq_matches_jax(arch):
    """The final activations, every layer's cache entry (stacked) and the
    MoE load-balance loss (0 without MoE)."""
    ref, got = _port_run(arch)
    (x, cache, aux), (wx, wcache, waux) = got["forward"], ref["forward"]
    _close(x, wx, what="x")
    close_tree(cache, wcache, what="cache")
    assert aux.dtype == torch.float32
    _close(aux, waux, what="aux")
    assert (float(aux) == 0.0) == (ref["cfg"].moe is None)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    """Logits, ``pos`` and the decode cache: padded to ``SMAX`` (gqa,
    mla), recurrent states (rwkv6), Hymba's per-layer rings (the 12-token
    prompt restacked into the local layer's 8-slot ring)."""
    ref, got = _port_run(arch)
    (logits, cache, pos), (wl, wc, wp) = got["prefill"], ref["prefill"]
    _close(logits, wl, what="logits")
    close_tree(cache, wc, what="cache")
    assert pos.dtype == torch.int32
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wp))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_jax(arch):
    ref, got = _port_run(arch)
    for i, (lg, want) in enumerate(zip(got["decode"], ref["decode"])):
        _close(lg, want, what=f"step {i} logits")
    (c, pos), (wc, wp) = got["final"], ref["final"]
    close_tree(c, wc, what="cache")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(wp))


@pytest.mark.parametrize("arch", ["minitron_8b", "rwkv6_7b", "hymba_1p5b"])
def test_bf16_prefill_and_decode_match_jax(arch):
    """A smoke shape in bfloat16 (parameters and activations): logits and
    cache within ``BF16_REL``; the cache keeps bfloat16 (the recurrent
    states float32, as in the reference)."""
    ref, got = _port_run(arch, "bfloat16")
    (logits, cache, _), (wl, wc, _) = got["prefill"], ref["prefill"]
    assert logits.dtype == torch.bfloat16
    for (path, t), (_, w) in zip(leaves(cache), leaves(wc)):
        assert str(t.dtype)[6:] == str(np.asarray(w).dtype), path
    _close(logits, wl, BF16_REL, "prefill logits")
    close_tree(cache, wc, BF16_REL, "prefill cache")
    for i, (lg, want) in enumerate(zip(got["decode"], ref["decode"])):
        _close(lg, want, BF16_REL, f"step {i} logits")
    close_tree(got["final"][0], ref["final"][0], BF16_REL, "final cache")


def no_drops(cfg):
    """``cfg`` with a MoE capacity factor of n_experts / top_k: every
    expert holds every token of a call, so no path drops one (the
    sequence path's capacity follows the prompt, the decode path's the
    batch: with drops, the two route different tokens)."""
    if cfg.moe is None:
        return cfg
    e = cfg.moe
    return cfg.with_(moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_path_matches_sequence_path(arch):
    """The port alone: prefill a prompt, then decode the rest of a
    sequence token by token; each step's logits equal the full sequence's
    at that position (float32, ``F32_REL``). MoE configurations run with
    no capacity drops (``no_drops``)."""
    cfg = no_drops(TC.get_smoke(arch))
    params = TT.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(4)
    full = torch.from_numpy(_inputs(cfg, rng, S + STEPS))
    x, _, _ = TT.forward_seq(cfg, params, full, SH, collect_cache=False)
    want = t_layers.lm_logits(cfg, params, x, SH)
    logits, cache, pos = TT.prefill(cfg, params, full[:, :S], SH, SMAX)
    _close(logits, want[:, S - 1], what="prefill")
    for i in range(STEPS - 1):
        logits, cache, pos = TT.decode_step(cfg, params, full[:, S + i],
                                            cache, pos, SH)
        _close(logits, want[:, S + i], what=f"step {i}")


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_layer_windows_match_jax(arch):
    """None for a global layer where the reference has its NO_WINDOW
    sentinel; full and smoke configurations."""
    for get_j, get_t in ((JC.get, TC.get), (JC.get_smoke, TC.get_smoke)):
        want = JT.layer_windows(get_j(arch))
        got = TT.layer_windows(get_t(arch))
        if want is None:
            assert got is None
            continue
        assert [int(JT.NO_WINDOW) if w is None else w for w in got] == \
            np.asarray(want).tolist()


def _as_data(cfg):
    return {k: (dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
            for k, v in vars(cfg).items()}


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_configs_are_the_references(arch):
    for get_j, get_t in ((JC.get, TC.get), (JC.get_smoke, TC.get_smoke)):
        j, t = get_j(arch), get_t(arch)
        assert _as_data(j) == _as_data(t)
        assert j.n_params() == t.n_params()
        assert j.n_active_params() == t.n_active_params()
        assert str(t.pdtype).endswith(j.param_dtype)
        assert str(t.adtype).endswith(j.activation_dtype)
    for alias, name in JC.ALIASES.items():
        assert TC.ALIASES[alias] == name
    assert TC.ARCHS == JC.ARCHS
    assert TC.SHAPES.keys() == JC.SHAPES.keys()


def test_shard_ctx_is_one_device():
    """No axes: one device, every placement the identity. With axes (no
    mesh) the reference's queries answer as ``repro``'s ShardCtx does;
    the rank's coordinate is 0 and a cache is not split."""
    sh = ShardCtx()
    x = torch.ones(2, 3)
    assert sh.constrain(x, None, "model") is x and sh.act_btd(x) is x
    assert sh.act_bhsd(x, 4) is x
    assert sh.seq_shards == 1 and sh.batch_rows(4) == slice(None)
    axes = (("pod", 2), ("data", 2), ("model", 4))
    t, j = ShardCtx(axis_sizes=axes), JShard(axis_sizes=axes)
    for q in ("names", "batch_axes", "model_axis", "all_axes"):
        assert getattr(t, q) == getattr(j, q), q
    for n in (1, 4, 6, 8):
        assert t.batch_axes_for(n) == j.batch_axes_for(n)
        assert t.divides(n) == j.divides(n)
        assert t.head_axis(n) == j.head_axis(n)
    assert [t.size(a) for a in ("pod", "data", "model", "x")] == \
        [j.size(a) for a in ("pod", "data", "model", "x")]
    assert t.coord("model") == 0 and t.world == 16 and t.batch_size == 4
    assert t.act_bhsd(x, 4) is x
    with pytest.raises(ValueError, match="without a mesh"):
        t.group("model")
    # Without a mesh one process holds everything: the loss is the
    # one-device loss.
    ref = reference("minitron_8b")
    cfg = _port_cfg("minitron_8b")
    params = model_params_from_numpy(ref["params"], "cpu")
    batch = {"inputs": torch.from_numpy(ref["prompt"]),
             "labels": torch.from_numpy(ref["prompt"])}
    assert torch.equal(TT.loss_fn(cfg, params, batch, t)[0],
                       TT.loss_fn(cfg, params, batch, sh)[0])


# Leaves the reference initialises to constants (norms, lerp weights,
# RWKV's decay base, Mamba's dt bias, A and skip).
CONSTANT_LEAVES = {"norm", "q_norm", "kv_norm", "gn_w", "attn_out_norm",
                   "ssm_out_norm", "mu_r", "mu_k", "mu_v", "mu_w", "mu_g",
                   "decay_base", "dt_bias", "a_log", "d_skip"}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_tree_matches_jax(arch):
    """The port's own draw has the reference's tree, shapes and dtypes
    (the float32 leaves of RWKV and Mamba included), N(0, 0.02^2)
    entries and unit norms, and the reference's constant leaves."""
    ref = reference(arch)
    got = TT.init_params(TC.get_smoke(arch),
                          torch.Generator().manual_seed(7), "cpu")
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), ref["params"])
    have = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)[6:]), got)
    assert have == want
    mlp = got["layers"]["mlp"]
    w = mlp["w_k" if "w_k" in mlp else "w_in"]
    assert abs(float(w.std()) - 0.02) < 2e-3
    for path, t in leaves(got["layers"]):
        if path.rsplit("/", 1)[1] in CONSTANT_LEAVES:
            want_t = ref["params"]["layers"]
            for k in path.split("/")[1:]:
                want_t = want_t[k]
            # linspace and log may round one float32 ulp apart
            np.testing.assert_allclose(t.float().numpy(), want_t, rtol=0,
                                       atol=1e-6, err_msg=path)
    assert torch.equal(got["final_norm"], torch.ones_like(got["final_norm"]))
    again = TT.init_params(TC.get_smoke(arch),
                            torch.Generator().manual_seed(7), "cpu")
    assert torch.equal(again["embed"]["tokens"], got["embed"]["tokens"])


def test_model_params_from_numpy_keeps_bf16_bits():
    ref = reference("minitron_8b", "bfloat16")
    tree = model_params_from_numpy(ref["params"], "cpu")
    a = ref["params"]["layers"]["attn"]["wq"]
    t = tree["layers"]["attn"]["wq"]
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))


@pytest.mark.parametrize("arch", ["hymba_1p5b", "rwkv6_7b"])
def test_port_decodes_from_a_jax_cache(arch):
    """The reference's prefill cache (Hymba's tuple of per-layer ring
    dicts; RWKV's float32 states) carried across by
    ``model_params_from_numpy`` bit for bit: the port's ``decode_step``
    on it equals the reference's (``F32_REL``)."""
    ref = reference(arch)
    cfg = TC.get_smoke(arch)
    params = model_params_from_numpy(ref["params"], "cpu")
    _, jcache, jpos = ref["prefill"]
    cache = model_params_from_numpy(jax.tree.map(np.asarray, jcache), "cpu")
    assert isinstance(cache, tuple) == (arch == "hymba_1p5b")
    for (path, t), (_, w) in zip(leaves(cache), leaves(jcache)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w), path)
    lg, _, _ = TT.decode_step(cfg, params, torch.from_numpy(ref["steps"][0]),
                              cache, torch.from_numpy(np.array(jpos)), SH)
    _close(lg, ref["decode"][0], what="logits")


@pytest.mark.parametrize("sq, skv, window, causal, block_q, hq, hkv", [
    (16, 16, None, True, 4, 4, 2),       # four blocks, GQA 2:1
    (12, 12, 5, True, 4, 4, 4),          # windowed
    (10, 10, None, True, 4, 4, 1),       # ragged tail: one block
    (6, 14, 4, True, 1024, 4, 2),        # continuation, window
    (8, 8, None, False, 2, 2, 2),        # not causal
])
def test_chunked_attention_matches_jax(sq, skv, window, causal, block_q, hq,
                                       hkv):
    rng = np.random.default_rng(sq * 31 + skv)
    q = rng.standard_normal((2, hq, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, skv, 16)).astype(np.float32)
            for _ in range(2))
    want = j_ca.chunked_attention(q, k, v, causal=causal, window=window,
                                  block_q=block_q)
    got = t_ca.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window,
                                 block_q=block_q)
    _close(got, want, what="chunked")
    naive = t_ca.naive_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window)
    _close(naive, j_ca.naive_attention(q, k, v, causal=causal,
                                       window=window), what="naive")


@pytest.mark.parametrize("window", [None, 3])
def test_dist_decode_matches_jax(window):
    rng = np.random.default_rng(5 if window else 6)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((3, 2, 10, 16)).astype(np.float32)
            for _ in range(2))
    kv_len = np.array([1, 7, 10], np.int32)
    want = j_dec.dist_decode(q, k, v, jnp.asarray(kv_len), sh=JSH,
                             window=window)
    got = t_dec.dist_decode(*map(torch.from_numpy, (q, k, v, kv_len)),
                            sh=SH, window=window)
    assert got.dtype == torch.float32
    _close(got, want, what="dist_decode")


def test_layers_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    _close(t_layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           j_layers.rms_norm(x, w, 1e-5), what="rms_norm")
    pos = np.arange(7, dtype=np.float32) * 300
    cos, sin = t_layers.rope_tables(torch.from_numpy(pos), 16, 10000.0)
    jcos, jsin = j_layers.rope_tables(pos, 16, 10000.0)
    _close(cos, jcos, what="cos")
    _close(sin, jsin, what="sin")
    xr = rng.standard_normal((2, 3, 7, 16)).astype(np.float32)
    _close(t_layers.apply_rope(torch.from_numpy(xr), cos, sin),
           j_layers.apply_rope(xr, jcos, jsin), what="rope")
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.2 for n, s in
         (("w_in", (16, 24)), ("w_gate", (16, 24)), ("w_out", (24, 16)))}
    _close(t_layers.swiglu(torch.from_numpy(x), {k: torch.from_numpy(v)
                                                 for k, v in p.items()},
                           SH, torch.float32),
           j_layers.swiglu(x, p, JSH, jnp.float32), what="swiglu")
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    _close(t_layers.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels)),
           j_layers.cross_entropy(logits, labels), what="cross_entropy")


def test_decode_write_past_capacity_is_dropped_as_in_jax():
    """Lanes whose ``pos`` is at or past ``smax`` (an idle serving lane)
    write nothing and raise nothing, as JAX drops an out-of-range
    scatter; the other lanes' caches and every lane's logits equal the
    reference's."""
    arch = "gemma3_4b"
    ref = reference(arch)
    jcfg, cfg = ref["cfg"], TC.get_smoke(arch)
    params = model_params_from_numpy(ref["params"], "cpu")
    rng = np.random.default_rng(9)
    smax = 10
    cache = {n: rng.standard_normal((cfg.n_layers, 3, cfg.n_kv_heads, smax,
                                     cfg.head_dim_)).astype(np.float32)
             for n in ("k", "v")}
    pos = np.array([4, smax, smax + 7], np.int32)
    toks = rng.integers(0, cfg.vocab, 3).astype(np.int32)
    wl, wc, wp = jax.jit(lambda p, t, c, q: JT.decode_step(
        jcfg, p, t, c, q, JSH))(ref["params"], toks, cache, pos)
    tc = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    lg, tc, tp = TT.decode_step(cfg, params, torch.from_numpy(toks), tc,
                                torch.from_numpy(pos), SH)
    _close(lg, wl, what="logits")
    for n in ("k", "v"):
        _close(tc[n], wc[n], what=n)
        np.testing.assert_array_equal(tc[n][:, 1:].numpy(), cache[n][:, 1:])
    np.testing.assert_array_equal(tp.numpy(), np.asarray(wp))


def _entry_calls(cfg, params, prompt):
    """Each of the model's entry points that takes a product, as a call."""
    adt = cfg.adtype
    x = TT._embed(cfg, params, prompt, SH, frames_ndim=3)
    p0 = TT._layer(params, 0)
    cache = TT.init_cache(cfg, prompt.shape[0], SMAX, device="cpu")
    pos = torch.zeros(prompt.shape[0], dtype=torch.int32)
    positions = torch.arange(prompt.shape[1], dtype=torch.float32)
    return {
        "forward_seq": lambda: TT.forward_seq(cfg, params, prompt, SH,
                                              collect_cache=True),
        "prefill": lambda: TT.prefill(cfg, params, prompt, SH, SMAX),
        "decode_step": lambda: TT.decode_step(cfg, params, prompt[:, 0],
                                              cache, pos, SH),
        "swiglu": lambda: t_layers.swiglu(x, p0["mlp"], SH, adt),
        "gqa_project": lambda: t_layers.gqa_project(cfg, p0["attn"], x, adt),
        "gqa_attention": lambda: t_layers.gqa_attention(
            cfg, p0["attn"], x, SH, positions, None),
        "lm_logits": lambda: t_layers.lm_logits(cfg, params, x, SH),
    }


@pytest.mark.parametrize("entry", ["forward_seq", "prefill", "decode_step",
                                   "swiglu", "gqa_project", "gqa_attention",
                                   "lm_logits", "embed_frames"])
@pytest.mark.parametrize("caller", [True, False])
def test_products_accumulate_in_fp32(entry, caller, monkeypatch):
    """Every product the model's entry points take runs with cuBLAS's
    reduced-precision reduction of bfloat16 products off (the reference
    accumulates in float32), whatever the caller's setting, which is
    restored afterwards."""
    arch = "phi3_vision_4p2b" if entry == "embed_frames" else "minitron_8b"
    cfg = _port_cfg(arch, "bfloat16")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.from_numpy(_inputs(cfg, np.random.default_rng(3), 6)
                              if entry != "embed_frames" else
                              np.zeros((B, 6), np.int32))
    frames = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 6, cfg.frame_dim or 1)).astype(np.float32))
    calls = _entry_calls(cfg, params, prompt)
    calls["embed_frames"] = lambda: t_layers.embed_frames(
        cfg, params["embed"], frames, SH)
    mm = torch.backends.cuda.matmul
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append(mm.allow_bf16_reduced_precision_reduction)
        return matmul(a, b)

    saved = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = caller
    try:
        monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
        calls[entry]()
        after = mm.allow_bf16_reduced_precision_reduction
    finally:
        mm.allow_bf16_reduced_precision_reduction = saved
    assert seen and not any(seen), seen
    assert after is caller
