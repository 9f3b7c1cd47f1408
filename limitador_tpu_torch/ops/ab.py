"""Time the fused check (B1) and the replicated check (B6a) of two trees.

    python -m limitador_tpu_torch.ops.ab OTHER_CHECKOUT [--rounds 2]

Runs on one card. Each turn is a subprocess in one tree (the two trees'
libraries and modules share names) that builds its kernels, checks B1
and B6a against their plain versions, and prints the median device time
(CUDA events, 50 launches after 5 of warm-up) of each at H = 8192 hits
over a 1<<20-counter table, the inputs made from one numpy seed. The
turns go other, this, this, other for each round, so that a drift of the
card over the call shows as a difference between the two turns of one
tree. Prints one JSON line per turn and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_TURN = r'''
import json, sys
import numpy as np
import torch
from limitador_tpu_torch.ops import kernel as K

C, H, now = 1 << 20, 8192, 5_000_000
rng = np.random.default_rng(6)
dev = torch.device("cuda", 0)
values = rng.integers(0, 60, C + 1).astype(np.int32)
expiry = rng.integers(0, 2 * now, C + 1).astype(np.int32)
hits = rng.integers(0, 1000, C + 1).astype(np.int32)
values[C] = expiry[C] = hits[C] = 0
w = 1.0 / np.arange(1, C + 1) ** 0.99
slots = np.searchsorted(np.cumsum(w), rng.random(H) * w.sum())
cols = (slots.astype(np.int32), rng.integers(0, 3, H).astype(np.int32),
        rng.choice([1, 10, 100], H).astype(np.int32),
        np.full(H, 60_000, np.int32), np.arange(H, dtype=np.int32),
        rng.random(H) < 0.1, np.zeros(H, bool))
rv = np.where(rng.random(C + 1) < 0.5, rng.integers(0, 50, C + 1), 0)
re = rng.integers(0, 2 * now, C + 1)
base = [torch.from_numpy(a).to(dev) for a in (values, expiry, hits)]
args = [torch.from_numpy(a).to(dev) for a in cols]
remote = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (rv, re)]


def table():
    return K.CounterTableState(*(t.clone() for t in base))


def median_ms(fn):
    times = []
    for k in range(55):
        t = table()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(t)
        end.record()
        end.synchronize()
        if k >= 5:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


b1 = lambda t: K.check_and_update_batch(t, *args, now)
b6a = lambda t: K.replicated_check_batch(t, *remote, *args, now)
ta, tb = table(), table()
_, ra = K.check_and_update_batch(ta, *args, now)
rb = K.check_and_update_plain(tb, *args, now)
exact = all(torch.equal(x, y) for x, y in zip(list(ra) + list(ta),
                                              list(rb) + list(tb)))
ta, tb = table(), table()
_, ra = K.replicated_check_batch(ta, *remote, *args, now)
rb = K.replicated_check_plain(tb, *remote, *args, now)
exact = exact and all(torch.equal(x, y) for x, y in zip(
    list(ra) + list(ta), list(rb) + list(tb)))
print(json.dumps({"tree": sys.argv[1], "exact": exact,
                  "b1_ms": median_ms(b1), "b6a_ms": median_ms(b6a)}))
'''


def _turn(tree: str, label: str) -> dict:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    proc = subprocess.run(
        [sys.executable, "-c", _TURN, label], cwd=tree, env=env,
        capture_output=True, text=True, timeout=900,
    )
    if proc.returncode != 0:
        raise SystemExit(f"turn in {tree} failed:\n{proc.stderr}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other", help="the other tree's checkout")
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}")
    turns = []
    for _ in range(args.rounds):
        for tree, label in ((args.other, "other"), (here, "this"),
                            (here, "this"), (args.other, "other")):
            turns.append(_turn(tree, label))
    return 0 if all(t["exact"] for t in turns) else 1


if __name__ == "__main__":
    sys.exit(main())
