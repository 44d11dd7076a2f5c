"""Bubble-chain statistics from a -bubbleinfo.txt file.

Counterpart of ``scripts/plot_bubbles.py`` (the reference's chain-length
statistics and histogram); the histogram is optional, so the statistics
need no matplotlib.  Touches no tensor.

Usage: python -m ahsoka_tpu_torch.scripts.plot_bubbles <out>-bubbleinfo.txt
           [--pdf hist.pdf]
"""

import argparse
import re
import sys


def chain_sizes(path):
    sizes = []
    with open(path) as fh:
        for line in fh:
            m = re.match(r"chain id: (\d+)size: (\d+)", line)
            if m:
                sizes.append(int(m.group(2)))
    return sizes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bubbleinfo", help="path to <out>-bubbleinfo.txt")
    ap.add_argument("--pdf", default=None,
                    help="write a chain-length histogram to this PDF")
    args = ap.parse_args(argv)
    sizes = chain_sizes(args.bubbleinfo)
    if not sizes:
        print("no chains found")
        return 1
    sizes.sort()
    n = len(sizes)
    print(f"chains: {n}")
    print(f"bubbles total: {sum(sizes)}")
    print(f"chain length min/median/max: {sizes[0]} / "
          f"{sizes[n // 2]} / {sizes[-1]}")
    print(f"mean: {sum(sizes) / n:.2f}")
    if args.pdf:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipping histogram",
                  file=sys.stderr)
            return 0
        plt.figure(figsize=(6, 4))
        plt.hist(sizes, bins=min(50, max(5, n // 2)))
        plt.xlabel("bubbles per chain")
        plt.ylabel("count")
        plt.title("Bubble-chain lengths")
        plt.tight_layout()
        plt.savefig(args.pdf)
        print(f"wrote {args.pdf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
