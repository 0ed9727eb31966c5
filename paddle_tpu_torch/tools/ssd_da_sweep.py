"""The SSD backward's f32 dA against a float64 evaluation of its plain
version over many seeded draws, at ``chip_smoke.py``'s f32 SSD edge cases
(inputs drawn as its ``ssd_inputs`` draws them), on one card:

    python3 paddle_tpu_torch/tools/ssd_da_sweep.py [--draws 40] [--root DIR]

``--root`` imports ``paddle_tpu_torch`` from another checkout (say, an
unpacked parent commit), so that two versions of the kernel are held to the
same draws. dA sums the whole sequence's contributions, which cancel, so
its error against max |dA| varies from draw to draw far more than the
other gradients'; one draw per case, as ``chip_smoke.py`` takes, says
little about the tail. Prints, per case, the largest, second largest and
median error of dA over the draws, the draws above 1e-4 (the gate of
``chip_smoke.py``) and the largest error of the other gradients.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

CASES = ((2, 63, 3, 64, 64), (2, 65, 4, 64, 64), (2, 150, 3, 64, 128),
         (1, 100, 2, 128, 64), (1, 77, 2, 128, 128), (1, 1001, 13, 64, 64))
GATE = 1e-4


def sweep(torch, ssd, b, l, h, dh, ds, draws):
    """dA's error (max |kernel - float64| / max |float64|) on each draw,
    and the largest error of the other gradients."""
    import torch.nn.functional as F

    errs, other = [], 0.0
    for seed in range(draws):
        g = torch.Generator(device="cuda").manual_seed(1000 + seed)
        xc = torch.randn(b, l, h * dh + 2 * ds, generator=g, device="cuda")
        x = xc[..., :h * dh].unflatten(-1, (h, dh))
        B, C = xc[..., h * dh:h * dh + ds], xc[..., h * dh + ds:]
        dt = F.softplus(torch.randn(b, l, h, generator=g, device="cuda"))
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        D = torch.randn(h, generator=g, device="cuda")
        dy = torch.randn(b, l, h, dh, generator=g, device="cuda")
        ins = (x, dt, A, B, C, D)
        y, states = ssd.ssd_fwd(*ins)
        grads = ssd.ssd_bwd(*ins, states, dy)
        xs = [t.detach().double().requires_grad_() for t in ins]
        y_ref = ssd.ssd_chunked_reference(*xs, ssd.kernel_chunk(dh, ds))
        g_ref = torch.autograd.grad(y_ref, xs, dy.double())
        rel = [((a.double() - r).abs().max() / r.abs().max()).item()
               for a, r in zip(grads, g_ref)]
        errs.append(rel[2])
        other = max(other, *rel[:2], *rel[3:])
    return sorted(errs), other


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=40)
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from paddle_tpu_torch.ops.cuda import ssd

    if not torch.cuda.is_available():
        print("ssd_da_sweep: needs a card", file=sys.stderr)
        return 2
    print(f"ssd from {ssd.__file__} on {torch.cuda.get_device_name(0)}",
          flush=True)
    t0, every = time.perf_counter(), []
    for b, l, h, dh, ds in CASES:
        errs, other = sweep(torch, ssd, b, l, h, dh, ds, args.draws)
        every += errs
        print(f"b{b} l{l} h{h} dh{dh} ds{ds}: dA over {args.draws} draws: "
              f"max {errs[-1]:.3e}, 2nd {errs[-2]:.3e}, median "
              f"{errs[len(errs) // 2]:.3e}, > {GATE}: "
              f"{sum(e > GATE for e in errs)}; other gradients max "
              f"{other:.3e}", flush=True)
    every.sort()
    print(f"all {len(every)} draws: max {every[-1]:.3e}, > {GATE}: "
          f"{sum(e > GATE for e in every)}, > {GATE / 2}: "
          f"{sum(e > GATE / 2 for e in every)}; "
          f"{time.perf_counter() - t0:.0f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
