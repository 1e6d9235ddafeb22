#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 23 several times and compare its logits bit for bit.

    python3 scripts/repeat_phase23.py [--runs 2]

Phase 23 serves qwen3_30b_a3b at full width, 8 of its 48 layers, through
the one-process dropless model and through 2 expert-parallel ranks sharing
one card (``repro_torch.launch.parallel``).  Each run is a fresh process:
the one-process model's and the ranks' logits at every step are saved,
and every later run is compared with the first bit for bit (equal or not,
the largest difference, the elements that differ).  Prints the card's name
and power limit and one JSON line with every comparison.  Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PHASE23 = ["--arch", "qwen3_30b_a3b", "--layers", "8", "--ranks", "2", "--batch", "4",
           "--prompt", "512"]


def child(save: Path) -> None:
    """One run of phase 23: the logits saved."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import parallel
    ref = parallel.reference(parallel.parse_args(PHASE23))
    torch.cuda.empty_cache()
    ranks = parallel.launch(parallel.parse_args(PHASE23))
    torch.save({"one process": logits_of(ref), **{f"rank {r['rank']}": logits_of(r)
                                                  for r in ranks}}, save)


def logits_of(tree, path="") -> dict:
    """{path: tensor} of every tensor under a key named "logits"."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(logits_of(v, f"{path}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(logits_of(v, f"{path}/{i}"))
    elif torch.is_tensor(tree) and "logits" in path:
        out[path] = tree
    return out


def compare(a: dict, b: dict) -> dict:
    """For each tensor of run ``a`` and run ``b``: equal, largest |a - b|,
    the elements that differ."""
    out = {}
    for who in a:
        for path, x in a[who].items():
            diff = (x.float() - b[who][path].float()).abs()
            out[f"{who}{path}"] = {"equal": bool(torch.equal(x, b[who][path])),
                                   "max_abs": float(diff.max()), "differ": int((diff > 0).sum())}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(Path(args.child))
        return
    if not torch.cuda.is_available():
        sys.exit("repeat_phase23: no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for i in range(args.runs):
            save = Path(tmp) / f"run{i}.pt"
            subprocess.run([sys.executable, __file__, "--child", str(save)], check=True)
            runs.append(torch.load(save, weights_only=False))
    report = {f"run 1 against run {i + 1}": compare(runs[i], runs[0])
              for i in range(1, len(runs))}
    report["runs agree"] = all(c["equal"] for pair in report.values() for c in pair.values())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(json.dumps(report))


if __name__ == "__main__":
    main()
