"""The port's ``training.checkpoint`` (``torch.distributed.checkpoint`` under
a step-indexed manager) held to the JAX package's ``tests/test_checkpoint.py``.

On one CPU device, ``CONFIG_TINY`` trained with AdamW, lion and adafactor:
a round trip restores every parameter, optimizer slot and count bit for
bit; resume continues identically; retention keeps ``max_to_keep``; the
save interval skips; an empty directory restores nothing and leaves the
state untouched; a truncated or garbled newest step (``robustness.
corrupt_latest_checkpoint``) falls back to the previous one with the
corrupt/fallback trail, and ``strict`` raises; a step saved before the
first update restores an optimizer with no state. The snapshot is taken
before ``save`` returns: a step right after it does not reach the files.
``restore_params_for_serving`` lays the parameters out as the serving
weights and generate gives the trained model's tokens. Across meshes: a
(2, 2) mesh of thread ranks saves its shards and one device restores them,
and one device's checkpoint restores onto the (2, 2) mesh (each rank its
shards), bit-equal both ways.
"""

import numpy as np
import pytest
import torch

from learning_jax_sharding_tpu_torch.models.generate import make_generate_fn
from learning_jax_sharding_tpu_torch.models.transformer import (
    CONFIG_TINY,
    Transformer,
    next_token_loss,
)
from learning_jax_sharding_tpu_torch.parallel import run_on_threads
from learning_jax_sharding_tpu_torch.robustness import corrupt_latest_checkpoint
from learning_jax_sharding_tpu_torch.telemetry import FlightRecorder
from learning_jax_sharding_tpu_torch.tenancy.hot_swap import serving_shardings
from learning_jax_sharding_tpu_torch.training import loop
from learning_jax_sharding_tpu_torch.training.checkpoint import (
    CheckpointManager,
    restore_params_for_serving,
)
from learning_jax_sharding_tpu_torch.training.pipeline import (
    make_train_step,
    sharded_train_state,
)
from tests import _torch_mesh_bodies as bodies

torch.set_num_threads(1)

OPTIMIZERS = {"adamw": loop.adamw(3e-3), "lion": loop.lion(1e-3),
              "adafactor": loop.adafactor(1e-2)}


def _batch(seed=0):
    tokens = np.random.default_rng(seed).integers(0, CONFIG_TINY.vocab_size, (8, 33))
    return {"inputs": tokens[:, :-1].astype(np.int64), "targets": tokens[:, 1:].astype(np.int64)}


def _setup(optimizer="adamw", seed=0):
    state = sharded_train_state(Transformer(CONFIG_TINY, device="cpu", seed=seed),
                                OPTIMIZERS[optimizer])
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    return batch, state, make_train_step(loss_fn=next_token_loss)


def _snapshot(state):
    named = list(state.model.named_parameters())
    return ({n: p.detach().clone() for n, p in named},
            {n: {k: v.clone() for k, v in state.optimizer.state[p].items()} for n, p in named
             if p in state.optimizer.state},
            state.step, state.updates)


def _assert_state(state, snap):
    params, slots, step, updates = snap
    assert (state.step, state.updates) == (step, updates)
    named = dict(state.model.named_parameters())
    for n, p in named.items():
        assert torch.equal(p.detach(), params[n]), n
    assert {n for n, p in named.items() if p in state.optimizer.state} == set(slots)
    for n, kv in slots.items():
        got = state.optimizer.state[named[n]]
        assert set(got) == set(kv), n
        for k, v in kv.items():
            assert torch.equal(got[k], v), (n, k)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
def test_roundtrip_preserves_values(optimizer, tmp_path):
    batch, state, step = _setup(optimizer)
    for _ in range(3):
        step(state, batch)
    with CheckpointManager(tmp_path / "ckpt") as ckpt:
        assert ckpt.save(3, state)
        ckpt.wait()
        _, fresh, _ = _setup(optimizer, seed=1)
        restored = ckpt.restore(3, like=fresh)
    assert restored is fresh
    _assert_state(fresh, _snapshot(state))


def test_snapshot_is_taken_before_save_returns(tmp_path):
    """The state is updated in place: a step right after ``save`` must not
    reach the checkpoint the background writer is still writing."""
    batch, state, step = _setup()
    step(state, batch)
    before = _snapshot(state)
    with CheckpointManager(tmp_path) as ckpt:
        ckpt.save(1, state)
        step(state, batch)                     # mutates every tensor saved
        ckpt.wait()
        _, fresh, _ = _setup(seed=1)
        ckpt.restore(1, like=fresh)
    _assert_state(fresh, before)


def test_resume_continues_identically(tmp_path):
    """Train 2 + save + train 2 more == restore + train 2 more."""
    batch, state, step = _setup()
    for _ in range(2):
        step(state, batch)
    with CheckpointManager(tmp_path / "ckpt") as ckpt:
        ckpt.save(2, state)
        cont = [float(step(state, batch)[1]) for _ in range(2)]
        _, fresh, step2 = _setup(seed=1)
        resumed = ckpt.restore_latest(like=fresh)
    res = [float(step2(resumed, batch)[1]) for _ in range(2)]
    np.testing.assert_allclose(cont, res, rtol=1e-6)
    assert cont == res                          # and bit-equal on one device


def test_retention_and_latest(tmp_path):
    batch, state, step = _setup()
    with CheckpointManager(tmp_path / "ckpt", max_to_keep=2) as ckpt:
        for s in (1, 2, 3):
            step(state, batch)
            ckpt.save(s, state)
        ckpt.wait()
        assert ckpt.latest_step() == 3
        assert ckpt.all_steps() == [2, 3]
        assert not ckpt.save(3, state, force=True)   # a saved step stays


def test_save_interval_and_first_update(tmp_path):
    """Step 0 is on the interval (and saved before any update, with no
    optimizer state: restoring it clears a stepped optimizer's)."""
    batch, state, step = _setup()
    before = _snapshot(state)
    with CheckpointManager(tmp_path / "ckpt", save_interval_steps=5) as ckpt:
        assert ckpt.save(0, state)
        assert not ckpt.save(3, state)
        assert ckpt.save(3, state, force=True)
        ckpt.wait()
        assert ckpt.all_steps() == [0, 3]
        step(state, batch)
        ckpt.restore(0, like=state)
    _assert_state(state, before)
    assert not state.optimizer.state


def test_restore_latest_empty_dir_returns_none(tmp_path):
    batch, state, step = _setup()
    before = _snapshot(state)
    with CheckpointManager(tmp_path / "empty") as ckpt:
        assert ckpt.restore_latest(like=state) is None
    _assert_state(state, before)


@pytest.mark.parametrize("mode", ["truncate", "garble"])
def test_corrupted_latest_falls_back_to_previous(mode, tmp_path):
    batch, state, step = _setup()
    step(state, batch)
    first = _snapshot(state)
    rec = FlightRecorder()
    with CheckpointManager(tmp_path / "ckpt", recorder=rec) as ckpt:
        ckpt.save(1, state)
        step(state, batch)
        ckpt.save(2, state)
        ckpt.wait()
        assert corrupt_latest_checkpoint(tmp_path / "ckpt", mode=mode, recorder=rec) == 2
        _, fresh, _ = _setup(seed=1)
        restored = ckpt.restore_latest(like=fresh)
        _assert_state(restored, first)
        assert [e["step"] for e in rec.events("checkpoint.corrupt")] == [2]
        assert rec.events("checkpoint.fallback")[0]["restored_step"] == 1
        assert rec.events("chaos.corrupt_checkpoint")[0]["mode"] == mode
        with pytest.raises(Exception):
            ckpt.restore_latest(like=fresh, strict=True)
    assert corrupt_latest_checkpoint(tmp_path / "none") is None
    with pytest.raises(ValueError, match="unknown mode"):
        corrupt_latest_checkpoint(tmp_path / "ckpt", mode="melt")


def test_restore_params_for_serving_gives_generates_tokens(tmp_path):
    batch, state, step = _setup()
    for _ in range(2):
        step(state, batch)
    live = {k: torch.zeros_like(v) for k, v in state.model.state_dict().items()}
    dst = serving_shardings(live)
    gen = make_generate_fn(CONFIG_TINY, max_new_tokens=6, device="cpu")
    prompt = torch.from_numpy(_batch(1)["inputs"][:2, :8])
    want = gen(state.model.state_dict(), prompt)
    with CheckpointManager(tmp_path / "ckpt") as ckpt:
        ckpt.save(2, state)
        ckpt.wait()
        _, fresh, _ = _setup(seed=1)
        staged, stats = restore_params_for_serving(ckpt, like=fresh, dst_shardings=dst)
    for k, v in state.model.state_dict().items():
        assert torch.equal(staged[k], v), k
    assert stats["bytes"] > 0
    assert torch.equal(gen(staged, prompt), want)
    with CheckpointManager(tmp_path / "empty") as ckpt:
        assert restore_params_for_serving(ckpt, like=fresh, dst_shardings=dst) is None


def test_restore_across_meshes(tmp_path):
    """(2, 2) → one device and one device → (2, 2), RULES_DP_TP, bit-equal:
    each rank writes and reads only its shards."""
    sd = {k: v.numpy() for k, v in Transformer(CONFIG_TINY, device="cpu", seed=0)
          .state_dict().items()}
    batch, one, step = _setup(seed=3)
    step(one, batch)
    with CheckpointManager(tmp_path / "one") as ckpt:
        ckpt.save(1, one)
    got = run_on_threads(bodies.checkpoint_body, (2, 2), ("data", "model"),
                         args=(sd, _batch(), str(tmp_path / "mesh"), str(tmp_path / "one")))
    # One device's checkpoint on the mesh: every parameter and moment whole.
    restored = got["restored"]
    assert restored["step"] == 1
    for n, p in one.model.named_parameters():
        np.testing.assert_array_equal(restored["params"][n], p.detach().numpy(), err_msg=n)
        np.testing.assert_array_equal(restored["exp_avg_sq"][n],
                                      one.optimizer.state[p]["exp_avg_sq"].numpy(), err_msg=n)
    assert restored["local"]["blocks.0.ff.up.weight"] == (CONFIG_TINY.hidden // 2,
                                                           CONFIG_TINY.features)
    # The mesh's checkpoint on one device.
    _, fresh, _ = _setup(seed=5)
    with CheckpointManager(tmp_path / "mesh") as ckpt:
        assert ckpt.all_steps() == [2]
        ckpt.restore_latest(like=fresh)
    assert (fresh.step, fresh.updates) == (2, 2)
    for n, p in fresh.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), got["saved"]["params"][n], err_msg=n)
        np.testing.assert_array_equal(fresh.optimizer.state[p]["exp_avg_sq"].numpy(),
                                      got["saved"]["exp_avg_sq"][n], err_msg=n)
