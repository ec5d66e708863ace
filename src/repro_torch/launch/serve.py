"""Batched serving launcher: continuous batching + Scavenger-paged KV cache,
on the PyTorch port (CUDA unless ``--device`` names another device; it
raises without one).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
      [--smoke] [--device cpu] [--requests 8] [--max-new 12]

The flags and the two ``[serve]`` lines are the reference launcher's
(``launch/serve.py`` of the reference package); the weights are a seeded
init (``--seed``), as are the requests' prompts.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.accel import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve.engine import Request, ServeEngine


def draw_requests(vocab: int, n: int, max_new: int,
                  seed: int = 0) -> list[Request]:
    """The launcher's traffic: ``n`` requests with prompts of 4-15 tokens
    drawn from ``seed``, hot unless ``rid % 4 == 0``."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(4, 16))
        prompt = rng.integers(0, vocab, plen).tolist()
        out.append(Request(rid=rid, prompt=prompt, max_new=max_new,
                           hot=rid % 4 != 0))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--shards", type=int, default=1,
                    help="shard the paged-cache metadata store N ways")
    ap.add_argument("--shard-policy", choices=("hash", "range"),
                    default="hash")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; raises without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg, seed=args.seed, device=device)
    engine = ServeEngine(model, batch_slots=args.slots,
                         cache_len=args.cache_len,
                         meta_shards=args.shards,
                         meta_shard_policy=args.shard_policy, device=device)
    t0 = time.time()
    for req in draw_requests(cfg.vocab, args.requests, args.max_new,
                             seed=args.seed):
        engine.submit(req)
    engine.run()        # ends in a sampled token's copy to the host
    dt = time.time() - t0
    toks = args.requests * args.max_new
    print(f"[serve] {args.requests} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / dt:.1f} tok/s)")
    print("[serve] pager:", json.dumps(engine.stats()))


if __name__ == "__main__":
    main()
