"""The port's data pipeline and checkpoints, on the CPU.

Data: the Markov recurrence (``data.markov_tokens``) on JAX's own draws
equals the reference's ``lax.scan`` exactly (integers), at a smoke and at
internlm2's vocabulary and sequence; batches are a pure function of
``(seed, step)``: deterministic, resumable, shifted labels, a learnable
structure (as ``tests/test_substrate.py`` checks the reference).

Checkpoints: round trip, atomicity, the async manager's retention, the
dtype restored; the on-disk format shared with the reference (a
checkpoint the port writes loads in ``repro.ckpt.load_checkpoint``, and
the reverse, bit for bit, an ``OptState`` and bfloat16 included); and a
save followed by an in-place optimizer step leaves the saved arrays
unchanged.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as JK
from repro.optim import init_opt_state as j_init_opt

from repro_torch import ckpt as TK
from repro_torch.data import (DataConfig, batch_specs, make_batch,
                              make_batch_iterator, markov_tokens)
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state


# --------------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("vocab,seq", [(128, 64), (92544, 2048), (50, 17),
                                       (64, 1)])
def test_markov_recurrence_matches_jax_scan(vocab, seq):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    k1, k2 = jax.random.split(key)
    x0 = jax.random.randint(k1, (4, 1), 0, vocab)
    noise = jax.random.randint(k2, (4, seq), 0, max(2, vocab // 64))

    def stepfn(x, n):
        nxt = (x * 31 + 7 + n) % vocab
        return nxt, nxt

    _, s = jax.lax.scan(stepfn, x0[:, 0], noise.T)
    want = np.concatenate([np.asarray(x0), np.asarray(s).T], axis=1)
    got = markov_tokens(torch.tensor(np.asarray(x0)[:, 0]),
                        torch.tensor(np.asarray(noise)), vocab)
    np.testing.assert_array_equal(got.numpy(), want)


def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=4, seed=7)
    it1 = make_batch_iterator(cfg, device="cpu")
    batches = [next(it1) for _ in range(5)]
    s, b3 = next(make_batch_iterator(cfg, start_step=3, device="cpu"))
    assert s == 3
    assert torch.equal(b3["inputs"], batches[3][1]["inputs"])
    assert torch.equal(b3["labels"], batches[3][1]["labels"])
    assert not torch.equal(batches[0][1]["inputs"], batches[1][1]["inputs"])
    _, b = batches[0]
    assert b["inputs"].dtype == b["labels"].dtype == torch.int32
    assert torch.equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    other = make_batch(DataConfig(vocab=128, seq_len=16, global_batch=4,
                                  seed=8), 0, "cpu")
    assert not torch.equal(other["inputs"], b["inputs"])


def test_data_has_learnable_structure():
    cfg = DataConfig(vocab=64, seq_len=128, global_batch=8)
    b = make_batch(cfg, 0, "cpu")
    x, nxt = b["inputs"].numpy(), b["labels"].numpy()
    assert float(np.mean(np.abs((x * 31 + 7) % 64 - nxt) <= 2)) > 0.9


def test_frames_and_specs():
    cfg = DataConfig(vocab=32, seq_len=8, global_batch=2, frontend="frames",
                     frame_dim=5)
    b = make_batch(cfg, 4, "cpu")
    assert b["inputs"].shape == (2, 8, 5) and b["inputs"].dtype == \
        torch.float32
    assert torch.equal(b["inputs"], make_batch(cfg, 4, "cpu")["inputs"])
    assert int(b["labels"].max()) < 32
    specs = batch_specs(cfg)
    assert specs["inputs"].shape == (2, 8, 5)
    assert specs["inputs"].device.type == "meta"
    assert batch_specs(DataConfig(vocab=32, seq_len=8, global_batch=2)
                       )["inputs"].dtype == torch.int32


def test_data_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_batch(DataConfig(vocab=8, seq_len=4, global_batch=1), 0)


# --------------------------------------------------------------------------- #
# checkpoints
# --------------------------------------------------------------------------- #

def _tree():
    return {"params": {"w": torch.arange(6, dtype=torch.float32
                                         ).reshape(2, 3)},
            "opt": {"mu": torch.ones((2, 3)),
                    "step": torch.tensor(4, dtype=torch.int32)}}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    TK.save_checkpoint(str(tmp_path), 7, tree, {"cursor": 7})
    assert TK.latest_step(str(tmp_path)) == 7
    restored, manifest = TK.load_checkpoint(str(tmp_path), tree)
    assert manifest == {"step": 7, "cursor": 7}
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 4


def test_checkpoint_atomicity(tmp_path):
    """A leftover .tmp dir (a crashed write) is never picked up."""
    TK.save_checkpoint(str(tmp_path), 5, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert TK.latest_step(str(tmp_path)) == 5
    assert TK.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TK.load_checkpoint(str(tmp_path / "none"), _tree())


def test_checkpoint_manager_async_and_gc(tmp_path):
    mgr = TK.CheckpointManager(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        mgr.save(s, _tree())
    mgr.close()
    assert sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)) == \
        [30, 40]


def test_checkpoint_dtype_restored(tmp_path):
    tree = {"p": torch.full((3,), 1.5, dtype=torch.bfloat16)}
    TK.save_checkpoint(str(tmp_path), 1, tree)
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as z:
        assert z["p"].dtype == np.float32          # as the reference stores
    restored, _ = TK.load_checkpoint(str(tmp_path), tree)
    assert restored["p"].dtype == torch.bfloat16
    assert torch.equal(restored["p"], tree["p"])


def _train_trees(rng):
    """A parameter tree (bfloat16 and float32 leaves, nested) with its
    optimizer state, as numpy arrays."""
    p = {"embed": {"tokens": rng.standard_normal((6, 4))},
         "layers": {"attn": {"wq": rng.standard_normal((2, 4, 4))}},
         "final_norm": rng.standard_normal((4,))}
    return jax.tree.map(lambda x: x.astype(np.float32), p)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    p = _train_trees(rng)
    tp = jax.tree.map(torch.from_numpy, p)
    tp["final_norm"] = tp["final_norm"].to(torch.bfloat16)
    ts = init_opt_state(tp)
    ts.mu["layers"]["attn"]["wq"].normal_(generator=torch.Generator()
                                          .manual_seed(1))
    ts = ts._replace(step=torch.tensor(3, dtype=torch.int32))
    TK.save_checkpoint(str(tmp_path), 3, (tp, ts), {"cursor": 3})
    jp = jax.tree.map(jnp.asarray, p)
    jp["final_norm"] = jp["final_norm"].astype(jnp.bfloat16)
    (rp, rs), manifest = JK.load_checkpoint(str(tmp_path),
                                            (jp, j_init_opt(jp)))
    assert manifest == {"step": 3, "cursor": 3}
    assert rs.step.dtype == np.int32 and int(rs.step) == 3
    assert rp["final_norm"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(rp["final_norm"], np.float32),
                                  tp["final_norm"].float().numpy())
    np.testing.assert_array_equal(np.asarray(rs.mu["layers"]["attn"]["wq"]),
                                  ts.mu["layers"]["attn"]["wq"].numpy())
    np.testing.assert_array_equal(np.asarray(rp["embed"]["tokens"]),
                                  p["embed"]["tokens"])


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    p = _train_trees(rng)
    jp = jax.tree.map(jnp.asarray, p)
    jp["embed"]["tokens"] = jp["embed"]["tokens"].astype(jnp.bfloat16)
    js = j_init_opt(jp)._replace(step=jnp.int32(9))
    JK.save_checkpoint(str(tmp_path), 9, (jp, js))
    tp = jax.tree.map(lambda x: torch.zeros(x.shape), p)
    tp["embed"]["tokens"] = tp["embed"]["tokens"].to(torch.bfloat16)
    (rp, rs), manifest = TK.load_checkpoint(str(tmp_path),
                                            (tp, init_opt_state(tp)))
    assert manifest["step"] == 9 and int(rs.step) == 9
    assert rp["embed"]["tokens"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        rp["embed"]["tokens"].float().numpy(),
        np.asarray(jp["embed"]["tokens"], np.float32))
    np.testing.assert_array_equal(rp["layers"]["attn"]["wq"].numpy(),
                                  p["layers"]["attn"]["wq"])


def test_save_snapshots_before_an_in_place_step(tmp_path):
    """The manager copies the tree when ``save`` returns: the in-place
    AdamW step that follows cannot change what the writer saves."""
    params = {"w": torch.randn(64, 64)}
    state = init_opt_state(params)
    want = params["w"].clone()
    mgr = TK.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, (params, state))
    for _ in range(3):
        adamw_update(AdamWConfig(lr_peak=0.1, warmup_steps=0), params,
                     {"w": torch.randn(64, 64)}, state)
    mgr.close()
    assert not torch.equal(params["w"], want)
    restored, _ = TK.load_checkpoint(str(tmp_path),
                                     (params, init_opt_state(params)))
    assert torch.equal(restored[0]["w"], want)
