"""Host-clock times of ViT-L16's eager optimizer step and training step, without
a profiler, on one card:

    python3 paddle_tpu_torch/tools/vit_step_time.py [--rounds 3] [--reps 3]

The model, optimizer and images are ``chip_smoke.py`` phase 13's (bf16
ViT-L16, AdamW with a global-norm clip, batch 64). Each round takes a fresh
backward under ``auto_cast(level="O2")`` and then times, ``--reps`` times
each and interleaved:

* ``step``: ``opt.step()`` outside any ``auto_cast``;
* ``step under O2``: ``opt.step()`` inside ``auto_cast(level="O2")`` (the
  step runs under ``amp.uncast``: torch's function modes off);
* ``step, mode on the stack``: the same clip and update with the autocast
  mode left on torch's stack but casting nothing, as a step inside
  ``auto_cast(enable=False)`` nested in ``auto_cast(level="O2")`` runs: the
  mode's Python call on every torch op;
* ``train_batch under O2``: ``Model.train_batch`` (forward, loss, backward,
  step, metrics; it ends in a host sync).

Each step time is taken twice: until the call returns (the host's share)
and until the card is done (``torch.cuda.synchronize``). Prints every
sample, then min / median / max per variant.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import amp

    if not torch.cuda.is_available():
        raise SystemExit("vit_step_time: needs a CUDA card")
    print(f"card: {cs.smi()}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = cs.vit_config()
    model = cs.vit_model(torch, args.seed)
    opt = model._optimizer
    data = cs.VitImages(cs.VIT_BATCH, cfg.image_size, args.seed)
    x, y = data.x, data.y
    n_params = sum(1 for p in model.parameters() if p.requires_grad)
    print(f"{cs.VIT_PRESET} bf16, batch {cs.VIT_BATCH}: {n_params} "
          f"parameter tensors, AdamW with ClipGradByGlobalNorm(1.0)")

    def backward():
        opt.clear_grad()
        model.network.train()
        with amp.auto_cast(level="O2"):
            xs, ys = model._to_device((x,)), model._to_device((y,))
            loss = model._loss(*model._forward(xs), *ys).mean()
            loss.backward()
        torch.cuda.synchronize()

    def step_on_stack():
        # Optimizer.step's body, without its uncast: the clip object's own
        # body and the update, with the outer mode still on torch's stack
        pg = [(p, p.grad) for p in opt._trainable() if p.grad is not None]
        with torch.no_grad():
            pg = opt._grad_clip._clip(pg)
        opt._apply(pg)
        opt._step_count += 1

    def outside():
        opt.step()

    def under_o2():
        with amp.auto_cast(level="O2"):
            opt.step()

    def mode_on_stack():
        with amp.auto_cast(level="O2"), amp.auto_cast(enable=False):
            step_on_stack()

    variants = {"step": outside, "step under O2": under_o2,
                "step, mode on the stack": mode_on_stack}
    # warm-up: two training steps, then each variant once
    for _ in range(2):
        with amp.auto_cast(level="O2"):
            model.train_batch(x, y)
    for fn in variants.values():
        backward()
        fn()
    torch.cuda.synchronize()
    ret = {k: [] for k in variants}
    done = {k: [] for k in variants}
    trains = []
    for r in range(args.rounds):
        for _ in range(args.reps):
            for name, fn in variants.items():
                backward()
                t0 = time.perf_counter()
                fn()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                ret[name].append((t1 - t0) * 1e3)
                done[name].append((t2 - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with amp.auto_cast(level="O2"):
                model.train_batch(x, y)
            trains.append((time.perf_counter() - t0) * 1e3)
        print(f"round {r + 1}: " + "; ".join(
            f"{k} {[round(t, 1) for t in done[k][-args.reps:]]} ms"
            for k in variants) + f"; train_batch under O2 "
            f"{[round(t, 1) for t in trains[-args.reps:]]} ms", flush=True)

    def summary(ts):
        return (f"min {min(ts):.1f}, median {statistics.median(ts):.1f}, "
                f"max {max(ts):.1f}")

    for k in variants:
        print(f"{k}: to return {summary(ret[k])} ms; to done "
              f"{summary(done[k])} ms ({len(done[k])} samples)")
    print(f"train_batch under O2: {summary(trains)} ms ({len(trains)} "
          f"samples)")


if __name__ == "__main__":
    main()
