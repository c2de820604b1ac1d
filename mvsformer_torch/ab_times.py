"""Parent against change on the card: the eval request and the training step.

    python -m mvsformer_torch.ab_times --parent DIR

Times, in this tree and in DIR (an unpacked earlier commit, e.g. `git
archive <commit> | tar -x -C scratch_chip/parent`), `chip_smoke.py`'s
phase 4 request (B=1, 5 views, 1152x1536, 192 depths, `make_infer_fn`) and
phase 8 step (`TrainStep` at B=8 as 2 micro-batches of 4, 5 views,
512x640): one warm-up, then 3 of each on the host clock, with the peak
memory of each. The trees run in turns, parent, change, change, parent,
each in a process of its own started in its directory, so each imports its
own `mvsformer_torch` and `chip_smoke`. Prints one JSON line per run.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

RUN = r'''
import json, sys, time
import torch
import chip_smoke as cs
from mvsformer_torch.config import Config, ModelConfig
from mvsformer_torch.infer import make_infer_fn
from mvsformer_torch.models.mvsformer import build_model, random_init_
from mvsformer_torch.train.step import TrainStep

def timed(fn, *args):
    fn(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, torch.cuda.max_memory_allocated() / 1e9

model = build_model(ModelConfig(), device="cuda")
random_init_(model, torch.Generator().manual_seed(0))
request_ms, request_gb = timed(make_infer_fn(model), *cs.synthetic_request(torch))
del model
torch.cuda.empty_cache()
cfg = Config()
model = build_model(cfg.arch, device="cuda", train=True)
random_init_(model, torch.Generator().manual_seed(1))
step_ms, step_gb = timed(TrainStep(model, cfg, seed=0),
                         cs.synthetic_batch(torch, 8, 5, 512, 640, with_gt=True))
print(json.dumps({"tree": sys.argv[1], "request_ms": request_ms, "request_gb": request_gb,
                  "step_ms": step_ms, "step_gb": step_gb, "card": cs.card_line()}))
'''


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="an unpacked earlier tree")
    args = parser.parse_args(argv)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for label, tree in (("parent", args.parent), ("change", here), ("change", here),
                        ("parent", args.parent)):
        res = subprocess.run([sys.executable, "-c", RUN, label], cwd=os.path.abspath(tree),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise RuntimeError(f"{label} run in {tree} failed:\n{res.stderr[-3000:]}")
        print(res.stdout.strip().splitlines()[-1], flush=True)


if __name__ == "__main__":
    main()
