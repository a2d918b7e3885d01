"""``fit``'s ms a step under each optimizer at the 125M train step's shape,
for two trees of the port on one card.

``chip_smoke.py``'s ``[train] fit with …`` lines, alone and longer: the
seeded 125M model (bf16 compute, flash attention, the fused loss) is
trained by ``training.loop.fit`` for ``STEPS`` steps of b=8, s=1024 of
seeded synthetic tokens, once under each of AdamW, lion and adafactor, in
``ROUNDS`` rounds (every other one in reverse order); an optimizer's
figure is the median of the MetricsLogger's ``seconds_per_step`` over its
rounds (the first step of a run has none).

``--tree DIR`` times the port found under ``DIR`` (one process a tree, so
two versions of the package never share an interpreter) and prints one
JSON line with the ms a step and the losses. ``--compare PARENT`` runs
``--tree PARENT``, ``--tree .``, ``--tree .``, ``--tree PARENT`` in turn
and prints each run's line, then a summary of the medians by tree and the
largest relative gap between the two trees' losses::

    python -m learning_jax_sharding_tpu_torch.scripts.perf_fit_optimizers \\
        --compare build/parent
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

STEPS, ROUNDS = 8, 2
OPTIMIZERS = ("adamw", "lion", "adafactor")
B, S = 8, 1024


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def time_tree(tree: str) -> dict:
    """One tree's fits, timed (the port imported from ``tree``)."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import dataclasses
    import functools

    import torch

    import learning_jax_sharding_tpu_torch as port
    from learning_jax_sharding_tpu_torch.data import SyntheticLMDataset
    from learning_jax_sharding_tpu_torch.models.transformer import (
        CONFIG_125M,
        Transformer,
        fused_next_token_loss,
    )
    from learning_jax_sharding_tpu_torch.ops import flash_attention as flash
    from learning_jax_sharding_tpu_torch.training.loop import TrainLoopConfig, fit

    cfg = dataclasses.replace(CONFIG_125M, attn_fn=flash.make_flash_attn_fn())
    kw = dict(loss_fn=functools.partial(fused_next_token_loss, chunk_size=128),
              step_kwargs=dict(loss_needs_params=True, apply_kwargs={"return_hidden": True}))
    stream = SyntheticLMDataset(CONFIG_125M.vocab_size, S, seed=0)
    rates = {name: [] for name in OPTIMIZERS}
    losses = {}
    for r in range(ROUNDS):
        for name in (OPTIMIZERS[::-1] if r % 2 else OPTIMIZERS):
            _, hist = fit(Transformer(cfg, device="cuda", seed=0), stream, None, None,
                          TrainLoopConfig(steps=STEPS, global_batch_size=B,
                                          learning_rate=3e-4, optimizer=name), **kw)
            rates[name] += [h["seconds_per_step"] for h in hist if "seconds_per_step" in h]
            losses[name] = [h["loss"] for h in hist]
            torch.cuda.empty_cache()
    return dict(tree=tree, package=str(Path(port.__file__).parent),
                ms_per_step={k: statistics.median(v) * 1e3 for k, v in rates.items()},
                seconds_per_step=rates, losses=losses, card=_card())


def compare(parent: str) -> int:
    lines = []
    for tree in (parent, ".", ".", parent):
        env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
        run = subprocess.run([sys.executable, __file__, "--tree", tree], env=env,
                             capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        line = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {}
    for name, tree in (("parent", parent), ("change", ".")):
        runs = [x for x in lines if x["tree"] == tree]
        summary[name] = {k: [x["ms_per_step"][k] for x in runs] for k in OPTIMIZERS}
    gap = {k: max(abs(a - b) / abs(b) for a, b in zip(lines[1]["losses"][k],
                                                        lines[0]["losses"][k]))
           for k in OPTIMIZERS}
    print(json.dumps({"summary": summary, "loss_rel_gap": gap, "card": lines[0]["card"]}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--tree", help="time the port under this directory")
    group.add_argument("--compare", metavar="PARENT",
                       help="parent, this tree, this tree, parent, one process each")
    args = ap.parse_args()
    if args.compare:
        return compare(args.compare)
    print(json.dumps(time_tree(args.tree)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
