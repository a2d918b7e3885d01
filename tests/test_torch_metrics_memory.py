"""The port's ``utils.metrics.MetricsLogger`` and ``utils.memory`` against
the JAX package's.

``MetricsLogger`` as in ``tests/test_metrics.py::TestMetricsLogger`` (the
JSONL file, the stderr line, ``log_every``, extra scalars) with torch
scalars, its ``train_*`` registry series, and the defaults the port sets
(``n_devices`` the process group's ranks or 1; no MFU on the CPU, which
has no peak). ``memory_plan`` equal to JAX's ``memory_plan`` (every field,
to the byte) at ``CONFIG_TINY`` and ``CONFIG_125M``, dense and flash
attention, fused and unfused loss heads, donated or not, at model and
data shard divisors 1, 2 and 4 and one or two optimizer slots.
``device_hbm_bytes`` is None on the CPU (no TPU figure stands in).
"""

import dataclasses
import io
import json

import jax.numpy as jnp
import pytest
import torch

from learning_jax_sharding_tpu.models import transformer as jax_tf
from learning_jax_sharding_tpu.utils import memory as jax_memory

from learning_jax_sharding_tpu_torch.models import transformer as tf
from learning_jax_sharding_tpu_torch.ops.flash_attention import make_flash_attn_fn
from learning_jax_sharding_tpu_torch.telemetry import MetricsRegistry
from learning_jax_sharding_tpu_torch.utils import memory
from learning_jax_sharding_tpu_torch.utils.metrics import MetricsLogger


def test_records_loss_throughput_and_jsonl(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    stream = io.StringIO()
    with MetricsLogger(path, stream=stream, flops_per_step=1e9, tokens_per_step=1024,
                       n_devices=2) as m:
        for step in range(3):
            assert m.log(step, loss=torch.tensor(2.5 - step)) is not None
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert lines[0]["loss"] == 2.5
    assert "seconds_per_step" not in lines[0]       # no predecessor, no rates
    for r in lines[1:]:
        assert r["seconds_per_step"] > 0
        assert r["tokens_per_second"] == pytest.approx(1024 / r["seconds_per_step"])
        assert r["tflops_per_chip"] == pytest.approx(1e9 / r["seconds_per_step"] / 2 / 1e12)
    out = stream.getvalue()
    assert "loss 2.5000" in out and "ms/step" in out and "tok/s" in out


def test_log_every_skips_but_still_syncs():
    with MetricsLogger(stream=None, log_every=5) as m:
        recs = [m.log(s, loss=float(s)) for s in range(11)]
    assert [r["step"] for r in recs if r is not None] == [0, 5, 10]
    assert len(m.history) == 3


def test_extra_scalars():
    with MetricsLogger(stream=None) as m:
        rec = m.log(0, loss=1.0, grad_norm=torch.tensor(0.25), lr=3e-4)
    assert rec["grad_norm"] == 0.25 and rec["lr"] == 3e-4


def test_registry_series_and_port_defaults():
    reg = MetricsRegistry()
    m = MetricsLogger(stream=None, flops_per_step=1e9, tokens_per_step=64, registry=reg)
    assert m._n_devices == 1                        # no process group
    for step in (1, 2, 3):
        m.log(step, loss=torch.tensor(1.0 / step))
    assert reg.get("train_steps_total").value == 3
    assert reg.get("train_loss").value == pytest.approx(1 / 3)
    assert reg.get("train_tokens_per_second").value > 0
    if not torch.cuda.is_available():
        assert all("mfu" not in r for r in m.history)   # no peak on the CPU


FLASH = {"dense": (None, None), "flash": (make_flash_attn_fn(), object())}
PLANS = [  # (batch, seq, keyword arguments)
    (8, 1024, {}),
    (8, 1024, dict(unfused_loss=True)),
    (16, 2048, dict(donate_state=False, optimizer_slots=1)),
    (8, 64, dict(n_model_shards=4)),
    (32, 1024, dict(n_data_shards=2, n_model_shards=2)),
    (4, 96, dict(n_data_shards=4, unfused_loss=True)),
]


@pytest.mark.parametrize("attn", list(FLASH))
@pytest.mark.parametrize("config", ["CONFIG_TINY", "CONFIG_125M"])
def test_memory_plan_equals_jax(config, attn):
    port_fn, jax_fn = FLASH[attn]
    cfg = dataclasses.replace(getattr(tf, config), attn_fn=port_fn)
    jcfg = dataclasses.replace(getattr(jax_tf, config), attn_fn=jax_fn)
    assert cfg.param_count == jcfg.param_count
    assert cfg.dtype.itemsize == jnp.dtype(jcfg.dtype).itemsize
    for b, s, kw in PLANS:
        got, want = memory.memory_plan(cfg, b, s, **kw), jax_memory.memory_plan(jcfg, b, s, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (b, s, kw)
        assert got.fits(80e9) == want.fits(80e9)


def test_device_hbm_bytes():
    assert memory.device_hbm_bytes("cpu") is None
    if torch.cuda.is_available():
        assert memory.device_hbm_bytes() == torch.cuda.get_device_properties(0).total_memory
    else:
        assert memory.device_hbm_bytes() is None
    assert not hasattr(memory, "HBM_BYTES")
