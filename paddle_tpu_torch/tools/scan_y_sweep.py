"""The selective scan forward's f32 y against a float64 recurrence over many
seeded draws, at ``chip_smoke.py``'s f32 scan cases (inputs drawn as its
``scan_inputs`` draws them), on one card:

    python3 paddle_tpu_torch/tools/scan_y_sweep.py [--draws 1000]

y sums n products ``h_t C_t`` that can cancel: at one step (l = 1, b = 1)
every channel's y is ``delta u`` times one shared sum ``C . B``, so a draw
whose sum nearly cancels makes max |y| small against the terms, and an f32
sum of the rounded terms (the plain version's) then lies far from float64
relative to max |y|; the kernel takes that share from an exact dot. One
draw per case, as ``chip_smoke.py`` takes, says little about that tail.
Prints, per case, the largest, second largest and median error over the
draws of the kernel against float64 (``chip_smoke.py``'s gate, 1e-4 of
max |y|), of the plain version against float64 and of the kernel against
the plain version, and the worst draw's three errors.
"""

from __future__ import annotations

import argparse
import os
import sys

GATE = 1e-4


def f64_scan(torch, u, delta, A, B, C):
    """The recurrence step by step in float64: y ``[b, l, d]``."""
    u, delta, A, B, C = (t.double() for t in (u, delta, A, B, C))
    h = torch.zeros(u.shape[0], u.shape[2], A.shape[1], dtype=torch.float64,
                    device=u.device)
    ys = []
    for t in range(u.shape[1]):
        h = torch.exp(delta[:, t, :, None] * A) * h \
            + delta[:, t, :, None] * B[:, t, None, :] * u[:, t, :, None]
        ys.append((h * C[:, t, None, :]).sum(-1))
    return torch.stack(ys, 1)


def sweep(torch, cs, ss, case, draws):
    b, l, d, n, strong = case
    rows = []
    for seed in range(draws):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        (u, delta, A, B, C), _ = cs.scan_inputs(torch, gen, b, l, d, n,
                                                torch.float32, strong)
        y = ss.selective_scan_fwd(u, delta, A, B, C)[0].double()
        p = ss.selective_scan_reference(u, delta, A, B, C).double()
        r = f64_scan(torch, u, delta, A, B, C)
        rows.append((((y - r).abs().max() / r.abs().max()).item(),
                     ((p - r).abs().max() / r.abs().max()).item(),
                     ((y - p).abs().max() / p.abs().max()).item()))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=1000)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops.cuda import selective_scan as ss

    if not torch.cuda.is_available():
        raise SystemExit("scan_y_sweep: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.smi()}")
    # the l = 1001 case is left out: its float64 loop is slow, and its y
    # sums many steps, which do not cancel as one step's can
    for case in cs.SCAN_CASES[:5]:
        rows = sweep(torch, cs, ss, case, args.draws)
        k64 = sorted(r[0] for r in rows)
        worst = max(rows)
        print(f"b{case[0]} l{case[1]} d{case[2]} n{case[3]} strong="
              f"{case[4]}: kernel vs float64 largest {k64[-1]:.3e}, second "
              f"{k64[-2]:.3e}, median {k64[len(k64) // 2]:.3e}, "
              f"{sum(e > GATE for e in k64)} of {len(k64)} draws above "
              f"{GATE}; plain vs float64 largest "
              f"{max(r[1] for r in rows):.3e}, kernel vs plain largest "
              f"{max(r[2] for r in rows):.3e}; the worst draw: "
              f"{worst[0]:.3e} / {worst[1]:.3e} / {worst[2]:.3e}",
              flush=True)


if __name__ == "__main__":
    main()
