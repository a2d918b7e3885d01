"""The port's case drivers run on the card unless asked for the CPU.

Cases 10, 14 and 17 (the last was CPU by default until its fault F7 was
repaired): ``main()`` with no argument hands ``device_type="cuda"`` to its
thread ranks, and ``--cpu`` on the command line picks the CPU. The mesh
runner is replaced by a recorder, so nothing runs here.
"""

import runpy
import sys

import pytest

from learning_jax_sharding_tpu_torch.cases import (
    case10_long_context,
    case14_sequence_parallel,
    case17_persistent_engine,
)

CASES = {"case10": case10_long_context, "case14": case14_sequence_parallel,
         "case17": case17_persistent_engine}


def _recorder(calls):
    def run_on_threads(fn, shape, axis_names, *, device_type="cpu", args=()):
        calls.append(device_type)
    return run_on_threads


@pytest.mark.parametrize("name", CASES)
def test_main_defaults_to_the_card(name, monkeypatch):
    module, calls = CASES[name], []
    monkeypatch.setattr(module, "run_on_threads", _recorder(calls))
    if name == "case10":
        monkeypatch.setattr(module, "single_device", lambda device_type: calls.append(
            device_type))
    module.main()
    assert calls and set(calls) == {"cuda"}


@pytest.mark.parametrize("argv,want", [([], "cuda"), (["--cpu"], "cpu")])
def test_case17_command_line(argv, want, monkeypatch):
    calls = []
    monkeypatch.setattr("learning_jax_sharding_tpu_torch.parallel.run_on_threads",
                        _recorder(calls))
    monkeypatch.setattr(sys, "argv", ["case17_persistent_engine", *argv])
    runpy.run_module("learning_jax_sharding_tpu_torch.cases.case17_persistent_engine",
                     run_name="__main__")
    assert calls == [want]
