"""The port's ``ServeEngine`` and ``launch.serve`` against the JAX
package's, on the CPU.

Both engines serve the same requests on the same parameters (JAX's
``init_params``, carried across by ``model_params_from_numpy``) in
float32. Every generated token must be equal; so that equality means
something, the test first asserts that every logit row a token was read
from (each admission's prefill row, each live lane's decode row) has a
top-2 margin above ``MARGIN`` on the reference's side, far above the two
sides' float32 difference (``test_torch_models.F32_REL``). The tier
``report()`` must be equal as a dict, which compares its floats exactly.
One run leaves a lane idle while another runs on, so its ``pos`` passes
``smax``: the reference drops that lane's cache writes, and the port must
too, with no error.

The MoE configurations' decode steps share a capacity over the batch,
idle lanes included, as in the reference: routing equal there is what
keeps their tokens equal. Hymba's caches are a tuple of per-layer dicts
whose lane axis is 0, and the reference's ``ServeEngine`` splices them on
axis 1 (into the heads, conv taps or channels): so hymba's tokens are
held to the reference's ``prefill`` and ``decode_step`` driven one
request at a time, its report to the reference's engine (the report
depends on lengths only), and a test shows the reference misplacing an
admitted lane where the port's equals the lane's own prefill.
"""
import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.core as jcore
from repro.launch import serve as j_serve
from repro.memtier import ServeEngine as JServe
from repro.memtier.engine import Request as JRequest
from repro.models import ShardCtx as JShard
from repro.models import transformer as JT

import repro_torch.configs as TC
import repro_torch.core as tcore
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as t_serve
from repro_torch.memtier import ServeEngine
from repro_torch.memtier.engine import Request

# A token read from a logit row whose top two stand closer than this
# (relative to the row's largest magnitude) could flip on a float32
# rounding; 1e-4 is ten times the models' float32 tolerance.
MARGIN = 1e-4


def _record(eng, rows, prefill):
    """Wrap the engine's ``_decode`` / ``_prefill`` to keep each logit row
    a token was read from: (request id or lane tag, row)."""
    dec, pre = eng._decode, eng._prefill

    def decode(*a):
        out = dec(*a)
        for i, r in enumerate(eng.active):
            if r is not None:
                rows.append((r.rid, np.asarray(out[0][i], np.float32)))
        return out

    def prefill_(*a):
        out = pre(*a)
        prefill.append(np.asarray(out[0][0], np.float32))
        return out

    eng._decode, eng._prefill = decode, prefill_


def _margin(row):
    top2 = np.sort(row)[-2:]
    return (top2[1] - top2[0]) / max(float(np.abs(row).max()), 1e-30)


def _requests(cfg, lens, news, seed):
    rng = np.random.default_rng(seed)
    out = []
    for rid, (n, m) in enumerate(zip(lens, news)):
        if cfg.frontend == "frames":
            prompt = rng.standard_normal((n, cfg.frame_dim)).astype(
                np.float32)
        else:
            prompt = rng.integers(0, cfg.vocab, n).astype(np.int32)
        out.append((rid, prompt, m))
    return out


def _serve_both(arch, *, lens, news, smax, batch, policy="hotness", pin=1,
                eos=None, seed=0):
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = model_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    kw = dict(n_fast_pages=4, n_slow_pages=128, chunk=16, policy=policy,
              hot_threshold=2)
    je = JServe(jcfg, jparams, batch_size=batch, smax=smax,
                emu_cfg=jcore.EmulatorConfig(**kw), policy=policy,
                eos=eos, pin_pages_per_seq=pin)
    te = ServeEngine(tcfg, tparams, batch_size=batch, smax=smax,
                     emu_cfg=tcore.EmulatorConfig(**kw), policy=policy,
                     eos=eos, pin_pages_per_seq=pin, device="cpu")
    logs = {}
    for name, eng, req in (("jax", je, JRequest), ("port", te, Request)):
        logs[name] = {"rows": [], "prefill": []}
        _record(eng, logs[name]["rows"], logs[name]["prefill"])
        reqs = [req(rid=r, prompt=p, max_new_tokens=m)
                for r, p, m in _requests(tcfg, lens, news, seed + 1)]
        for r in reqs:
            eng.submit(r)
        logs[name]["steps"] = eng.run()
        logs[name]["reqs"] = reqs
    return je, te, logs


def _assert_same_serving(je, te, logs):
    j, t = logs["jax"], logs["port"]
    rows = [r for _, r in j["rows"]] + j["prefill"]
    margins = [_margin(r) for r in rows]
    assert min(margins) > MARGIN, (
        f"a reference logit row has a top-2 margin of {min(margins):.2e}: "
        "the token comparison would test a rounding")
    assert len(j["rows"]) == len(t["rows"])
    for (jr, jrow), (tr, trow) in zip(j["rows"], t["rows"]):
        assert jr == tr
        scale = float(np.abs(jrow).max())
        assert float(np.abs(jrow - trow).max()) <= 1e-5 * scale
    assert j["steps"] == t["steps"]
    for a, b in zip(j["reqs"], t["reqs"]):
        assert a.out == b.out and a.done == b.done, a.rid
    assert je.report() == te.report()
    np.testing.assert_array_equal(np.asarray(je.pos), te.pos.numpy())


@pytest.mark.parametrize("arch, policy, pin", [
    ("minitron_8b", "hotness", 1), ("gemma3_4b", "static", 0),
    ("musicgen_medium", "write_bias", 1), ("phi3_mini_3p8b", "hotness", 2),
    ("rwkv6_7b", "hotness", 1), ("deepseek_v2_236b", "static", 1),
    ("phi35_moe_42b", "write_bias", 0)])
def test_serve_engine_matches_jax(arch, policy, pin):
    """Seven requests through three lanes (slots refilled from the queue):
    tokens, steps, every request's output and the report equal."""
    je, te, logs = _serve_both(arch, lens=[12, 20, 12, 28, 20, 12, 20],
                               news=[6, 9, 4, 7, 5, 8, 3], smax=48, batch=3,
                               policy=policy, pin=pin)
    _assert_same_serving(je, te, logs)
    assert te.report()["steps"] == logs["port"]["steps"]


def test_idle_lane_passes_smax_as_in_jax():
    """The last request ends early near ``smax`` while the one before runs
    on, so its idle lane's ``pos`` passes ``smax`` (the reference drops
    the lane's cache writes; the port must not index past the cache)."""
    smax = 40
    je, te, logs = _serve_both("gemma3_4b", lens=[12, 36], news=[20, 2],
                               smax=smax, batch=2)
    _assert_same_serving(je, te, logs)
    assert int(te.pos.max()) > smax


def test_serve_engine_eos_matches_jax():
    """An ``eos`` token that the model emits ends requests early on both
    sides at the same step."""
    je, te, logs = _serve_both("internlm2_1p8b", lens=[12, 20, 12, 20],
                               news=[12, 12, 12, 12], smax=48, batch=2)
    _assert_same_serving(je, te, logs)
    toks = [t for r in logs["port"]["reqs"] for t in r.out[1:]]
    eos = max(set(toks), key=toks.count)
    je2, te2, logs2 = _serve_both("internlm2_1p8b", lens=[12, 20, 12, 20],
                                  news=[12, 12, 12, 12], smax=48, batch=2,
                                  eos=eos)
    _assert_same_serving(je2, te2, logs2)
    ended = [r for r in logs2["port"]["reqs"] if len(r.out) < 12]
    assert ended and all(r.out[-1] == eos for r in ended)


def test_serve_engine_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TC.get_smoke("minitron_8b")
    params = t_serve.init_params(cfg, torch.Generator(), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_serve.init_params(cfg, torch.Generator())


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b",
                                  "musicgen-medium", "rwkv6-7b",
                                  "hymba-1.5b", "deepseek-v2-236b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_launch_serve_matches_jax(arch, capsys):
    """``python -m repro_torch.launch.serve --smoke`` against ``repro``'s:
    the report depends on the requests' lengths only, not on the
    weights, so the two draws give equal reports."""
    argv = ["--arch", arch, "--smoke", "--requests", "5", "--batch", "3",
            "--max-new", "6"]
    want = j_serve.run(argv)
    got = t_serve.run(argv + ["--device", "cpu"])
    assert got == want
    assert "served 5 requests" in capsys.readouterr().out


def _lane_by_lane(arch, lens, news, smax, seed=0):
    """Each request through the reference's ``prefill`` and
    ``decode_step`` on its own (batch 1, jitted): its tokens and the
    logit rows they were read from."""
    cfg = JC.get_smoke(arch)
    params = JT.init_params(cfg, jax.random.PRNGKey(seed))
    sh = JShard()
    pre = jax.jit(lambda p, i: JT.prefill(cfg, p, i, sh, smax))
    dec = jax.jit(lambda p, t, c, q: JT.decode_step(cfg, p, t, c, q, sh))
    out = []
    for rid, prompt, m in _requests(cfg, lens, news, seed + 1):
        logits, cache, pos = pre(params, prompt[None])
        rows = [np.asarray(logits[0], np.float32)]
        toks = [int(np.argmax(rows[-1]))]
        while len(toks) < m and int(pos[0]) < smax - 1:
            logits, cache, pos = dec(params, np.array(toks[-1:], np.int32),
                                     cache, pos)
            rows.append(np.asarray(logits[0], np.float32))
            toks.append(int(np.argmax(rows[-1])))
        out.append((rid, toks, rows))
    return out


def test_hymba_serve_engine_matches_jax_lane_by_lane():
    """Seven requests through three lanes of hymba's smoke model (prompts
    past the 8-token window, so prefill restacks the local layer's ring
    and decoding wraps it): every request's tokens equal the reference's
    ``prefill`` / ``decode_step`` over that request alone (after the
    top-2 margin assertion on every row), its logit rows within 1e-5, and
    the report equal to the reference ``ServeEngine``'s."""
    lens, news = [12, 20, 12, 28, 20, 12, 20], [6, 9, 4, 7, 5, 8, 3]
    je, te, logs = _serve_both("hymba_1p5b", lens=lens, news=news, smax=48,
                               batch=3)
    want = _lane_by_lane("hymba_1p5b", lens, news, smax=48)
    margins = [_margin(r) for _, _, rows in want for r in rows]
    assert min(margins) > MARGIN, min(margins)
    rows = {}
    for rid, row in logs["port"]["rows"]:
        rows.setdefault(rid, []).append(row)
    for (rid, toks, wrows), req, first in zip(
            want, logs["port"]["reqs"], logs["port"]["prefill"]):
        assert req.out == toks, rid
        got = [first] + rows.get(rid, [])[:len(toks) - 1]
        assert len(got) == len(wrows)
        for g, w in zip(got, wrows):
            assert float(np.abs(g - w).max()) <= 1e-5 * float(
                np.abs(w).max())
    assert je.report() == te.report()


def test_hymba_admission_splices_its_own_lane():
    """Three requests admitted into three lanes: the port's lane 2 holds
    exactly the cache of its own prefill (every layer's ring, conv and
    SSM state); the reference's splice on axis 1 misplaces it, so its
    lane 2 differs from its own prefill in every leaf."""
    cfg, tcfg = JC.get_smoke("hymba_1p5b"), TC.get_smoke("hymba_1p5b")
    jparams = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = model_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    emu = dict(n_fast_pages=4, n_slow_pages=128, chunk=16)
    je = JServe(cfg, jparams, batch_size=3, smax=24,
                emu_cfg=jcore.EmulatorConfig(**emu))
    te = ServeEngine(tcfg, tparams, batch_size=3, smax=24,
                     emu_cfg=tcore.EmulatorConfig(**emu), device="cpu")
    reqs = _requests(tcfg, [10, 14, 12], [4, 4, 4], 5)
    for rid, p, m in reqs:
        je.submit(JRequest(rid=rid, prompt=p, max_new_tokens=m))
        te.submit(Request(rid=rid, prompt=p, max_new_tokens=m))
    je._admit()
    te._admit()
    prompt = reqs[2][1][None]
    _, jown, _ = je._prefill(je.params, prompt)
    _, town, _ = te._prefill(te.params, torch.from_numpy(prompt))
    wrong = 0
    for l in range(cfg.n_layers):
        for name in ("k", "v", "conv", "ssm"):
            assert torch.equal(te.cache[l][name][2], town[l][name][0])
            np.testing.assert_allclose(
                te.cache[l][name][2].numpy(), np.asarray(jown[l][name][0]),
                rtol=0, atol=1e-5 * float(np.abs(jown[l][name]).max()))
            wrong += not np.array_equal(np.asarray(je.cache[l][name][2]),
                                        np.asarray(jown[l][name][0]))
    assert wrong == 4 * cfg.n_layers
