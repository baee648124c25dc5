"""The spread over seeds of ``chip_smoke.py`` phase 14(d)'s "twice the CPU's
distance to float64" rule, beside the same rule between two CPU runs.

Phase 14(d) runs one fp32 SGD step of each zoo builder on the card, on the
CPU and in float64 on the CPU (all on the card's ReLU masks and max-pool
choices), and passes an array that the card and the CPU part by more than
its limit (gradients 1e-3 of max-abs, moving statistics and weights 1e-5)
when the card's distance to float64 is at most twice the CPU's. For each
``--seeds`` value this runs that step of ``--model`` (default Inception-v3,
batch 8, 299 px, 16 classes, the weights and batch phase 14(d) draws from
the seed) twice, with the CPU at 8 threads (the rule's "CPU") and then at
1 thread, and keeps the float64 step of the first. For every array it
prints

- the rule's ratio, card / cpu8 (distances to float64), where the card
  and cpu8 part by more than the limit: the rule fails above 2;
- the control's ratio, cpu1 / cpu8, where cpu1 and cpu8 part by more than
  the limit: the same rule between two CPU runs of equal accuracy that
  differ only in the order of their sums.

Nothing here holds a limit. Run from the repo root on a machine with an
NVIDIA GPU:

    python3 mxnet_tpu_torch/tools/zoo_rule_spread.py [--seeds 0,1,2,3,4]

and the readings are written to ``zoo_rule_spread.json`` in
``chip_smoke.py``'s output directory.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
import mxnet_tpu_torch as mx  # noqa: E402

LIMITS = ((1, "grad", 1e-3), (2, "aux", 1e-5), (3, "weight", 1e-5))


def ratios(runs, a, b, ref="f64"):
    """For each array where runs ``a`` and ``b`` part by more than its
    limit: (distance of a to ``ref``) / (distance of b to ``ref``)."""
    out = {}
    for i, key, limit in LIMITS:
        for n in runs[b][i]:
            if cs._rel(runs[a][i][n], runs[b][i][n]) <= limit:
                continue
            da = cs._rel(runs[a][i][n], runs[ref][i][n])
            db = cs._rel(runs[b][i][n], runs[ref][i][n])
            out[f"{key} {n}"] = {"ratio": da / max(db, 1e-30),
                                 f"{a}_vs_f64": da, f"{b}_vs_f64": db}
    return out


def one_seed(model, seed):
    """Phase 14(d)'s steps of ``model`` at ``seed`` (its weights and
    batch), the CPU's at 8 and at 1 threads."""
    i, (name, kw, shape) = next(
        (i, z) for i, z in enumerate(cs.ZOO_SMALL) if z[0] == model)
    symbol = mx.models.get_model(name).get_symbol(
        num_classes=cs.ZOO_SMALL_CLASSES, **kw)
    weights = cs.net_weights(symbol, shape, seed + 150 + i)
    rng = np.random.default_rng(seed + 170 + i)
    x = rng.standard_normal(shape, dtype=np.float32)
    y = rng.integers(0, cs.ZOO_SMALL_CLASSES, shape[0]).astype(np.float32)
    threads = torch.get_num_threads()
    runs = {}
    try:
        for n in (8, 1):
            torch.set_num_threads(n)
            got = cs.card_cpu_f64_steps(mx, symbol, weights, x, y)[0]
            if n == 8:
                runs.update(got)
            else:
                runs["cpu1"] = got["cpu"]
                # the second card step; the control is exact when it gives
                # the same arrays (and so the same masks) as the first
                card_repeats = all(
                    np.array_equal(got["gpu"][j][k], runs["gpu"][j][k])
                    for j in (1, 2, 3) for k in got["gpu"][j])
    finally:
        torch.set_num_threads(threads)
    rule = ratios(runs, "gpu", "cpu")
    control = ratios(runs, "cpu1", "cpu")
    row = {"seed": seed, "model": name,
           "rule_max": max((r["ratio"] for r in rule.values()), default=0.0),
           "control_max": max((r["ratio"] for r in control.values()),
                              default=0.0),
           "rule_fails": sorted(n for n, r in rule.items()
                                if r["ratio"] > 2),
           "control_fails": sorted(n for n, r in control.items()
                                   if r["ratio"] > 2),
           "card_repeats": card_repeats, "rule": rule, "control": control,
           "seconds": {k: v[4] for k, v in runs.items()}}
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--model", default="inception-v3")
    args = ap.parse_args(argv)
    os.environ["MXTPU_NO_FUSED_STEP"] = "1"   # as phase 14(d) runs it
    card = cs.phase_device()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = one_seed(args.model, seed)
        rows.append(row)
        print(json.dumps({k: row[k] for k in (
            "seed", "model", "rule_max", "control_max", "rule_fails",
            "control_fails", "card_repeats", "seconds")}), flush=True)
    os.makedirs(os.path.join(ROOT, cs.OUT_DIR), exist_ok=True)
    with open(os.path.join(ROOT, cs.OUT_DIR, "zoo_rule_spread.json"),
              "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
