"""Time the segment-sum kernel of one checkout of the port on the card.

Compares two designs of kernel 2 (``csrc/segment_sum.cu``) on one card:
run it once per checkout, alternating, and compare the medians.

    python3 experiments/segsum_ab.py --label change
    python3 experiments/segsum_ab.py --root OTHER_CHECKOUT --label parent

``--root`` is the checkout whose ``elasticsearch_tpu_torch`` is imported
and built (default: this one); its kernels build into its own ``build/``.
The timer, the ordinal generator and the bound are ``chip_smoke.py``'s,
always this checkout's. Inputs (the f32-mask form at ``chip_smoke.py``'s
1M bench geometry, made from a seed): 2^20 docs, ordinals zipf s=1 over
2,000, values normal; a doc matches with probability 0.25, then 1.0.
Each case runs counts + sums and counts only, is checked against the
checkout's plain version (counts bit-equal, sums within 1e-4 x
sum |value| + 1e-3) and prints one JSON line.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ND = 1 << 20
DENSITIES = (0.25, 1.0)
SUM_RTOL, SUM_ATOL = 1e-4, 1e-3


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(ssum, timer, bound, ords, mask, vals, n_ords):
    """ms of count + sum and of count only, each checked against plain."""
    import torch
    out = {}
    for with_sum in (True, False):
        v = vals if with_sum else None

        def kernel():
            return ssum.segment_counts_sums(ords, mask, v, n_ords=n_ords)

        got = kernel()
        want = ssum.segment_sum_plain(ords, mask, v, n_ords=n_ords,
                                      with_count=True, with_sum=with_sum)
        if not torch.equal(got[0], want[0]):
            raise SystemExit("counts differ from the plain version")
        if with_sum:
            valid = (mask > 0) & (ords >= 0) & (ords < n_ords)
            tol = torch.bincount(ords[valid].long(),
                                 weights=vals[valid].abs().double(),
                                 minlength=n_ords) * SUM_RTOL + SUM_ATOL
            if not bool(((got[1].double() - want[1].double()).abs()
                         <= tol).all()):
                raise SystemExit("sums differ from the plain version")
        nbytes = ords.shape[0] * (8 + 4 * with_sum) + n_ords * (4 + 4 * with_sum)
        key = "count_sum" if with_sum else "count_only"
        out[key + "_ms"] = timer.ms(kernel)
        out[key + "_bound_ms"] = bound(nbytes, ords.shape[0] * (1 + with_sum))[0]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="change")
    args = ap.parse_args()
    cs = _chip_smoke()
    import torch
    if not torch.cuda.is_available():
        print("segsum_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from elasticsearch_tpu_torch.ops import cuda_kernels
    from elasticsearch_tpu_torch.ops import segment_sum as ssum
    if not ssum.__file__.startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {ssum.__file__}, not from {args.root}")
    cuda_kernels.library()
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    timer = cs.Timer(torch, dev)
    ords = torch.from_numpy(cs.zipf_ords(ND, cs.N_ORDS, 17)).to(dev)
    gen = torch.Generator(dev).manual_seed(3)
    vals = torch.randn(ND, device=dev, generator=gen)
    u = torch.rand(ND, device=dev, generator=gen)
    for density in DENSITIES:
        mask = (u < density).float()
        row = {"label": args.label, "root": args.root, "density": density,
               "nd": ND, "n_ords": cs.N_ORDS,
               "card": card.strip().splitlines()[0] if card else None}
        row.update(measure(ssum, timer, cs.bound, ords, mask, vals,
                           cs.N_ORDS))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
