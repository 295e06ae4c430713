"""Host microseconds a dispatch of the port's ``Scheduler``, two trees in
turns (first, second, second, first, repeated ``--rounds`` times).

Each run is a process of its own with one tree's package on ``sys.path``.
It drives that tree's ``Scheduler`` on the same deterministic paged core
(``engine/fakecore.py`` of the tree this script sits in, loaded by path),
over the same seeded traffic, with every plane at its default (off), and
times the Scheduler's ticks. The fake core's own calls are timed apart, so
``sched_us_a_dispatch`` is the Scheduler's host work alone: what the
serving host adds to each dispatch besides the model. No device is used.

    python scripts/torch_sched_host_ab.py <tree A> <tree B> [--rounds 3]
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKECORE = os.path.join(HERE, "generativeaiexamples_tpu_torch", "engine",
                        "fakecore.py")

_RUN = r"""
import importlib.util, json, sys, time
import numpy as np
tree, fake_path, n_req, seed = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
sys.path.insert(0, tree)
spec = importlib.util.spec_from_file_location("fakecore_ab", fake_path)
fake = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fake)
from generativeaiexamples_tpu_torch.engine.scheduler import Request, Scheduler


class Tok:
    eos_id = fake.EOS

    def decode(self, ids):
        return "".join(chr(65 + int(i) % 26) for i in ids)

    def encode(self, text, add_bos=False):
        return [ord(c) for c in text]


core = fake.FakeCore(batch=8, max_seq=512, page_size=16, chunk=64, steps=8,
                     group=4)
core_s = [0.0]
for name in ("prefill_group", "decode", "decode_multi"):
    fn = getattr(core, name)

    def timed(*a, _fn=fn, **kw):
        t = time.perf_counter()
        try:
            return _fn(*a, **kw)
        finally:
            core_s[0] += time.perf_counter() - t
    setattr(core, name, timed)
sched = Scheduler(core, Tok())
rng = np.random.default_rng(seed)


def traffic(n):
    return [Request(prompt_ids=[int(x) for x in rng.integers(
        32, 200, int(rng.integers(16, 200)))],
        max_tokens=int(rng.integers(64, 256)), temperature=0.0)
        for _ in range(n)]


def serve(reqs):
    for r in reqs:
        sched.submit(r)
    ticks = 0
    while not all(r.finished_at is not None for r in reqs):
        sched._tick()
        ticks += 1
        if ticks > 200000:
            raise AssertionError("requests did not finish")
    return ticks


serve(traffic(8))                      # warm the interpreter's paths
keys = ("prefill_dispatches", "decode_dispatches", "mixed_dispatches")
before = {k: sched.stats.get(k, 0) for k in keys}
core_s[0] = 0.0
t0 = time.perf_counter()
ticks = serve(traffic(n_req))
wall = time.perf_counter() - t0
dispatches = sum(sched.stats.get(k, 0) - before[k] for k in keys)
print(json.dumps({"wall_s": wall, "core_s": core_s[0], "ticks": ticks,
                  "dispatches": dispatches,
                  "decode_steps": sched.stats["decode_steps"],
                  "sched_us_a_dispatch": (wall - core_s[0]) / dispatches
                  * 1e6}))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    order = [trees[0], trees[1], trees[1], trees[0]] * args.rounds
    runs = []
    for tree in order:
        out = subprocess.run(
            [sys.executable, "-c", _RUN, tree, FAKECORE, str(args.requests),
             str(args.seed)], cwd=tree, capture_output=True, text=True,
            timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append({"tree": tree,
                     **json.loads(out.stdout.strip().splitlines()[-1])})
    summary = {tree: statistics.median(
        r["sched_us_a_dispatch"] for r in runs if r["tree"] == tree)
        for tree in trees}
    print(json.dumps({"runs": runs, "median_sched_us_a_dispatch": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
