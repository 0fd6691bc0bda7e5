"""Posting-table build microbenchmark (host-only, no device).

Times thermite_seed_index_new_stride on a synthetic random text at a
chosen scale, for the packed-u64 path (default) and optionally the
(key, pos) pair fallback (--pair, via THERMITE_TABLE_PAIR=1), printing
ns/position.  Use to project whole-genome build cost: the locality
cliff only shows past ~100 Mbp (the round-3 20 Mbp number extrapolated
147 ns/pos but the 6.4 GB build measured 1810 ns/pos on the old pair
path).

Usage: python tools/table_bench.py [Mbp] [stride] [k] [--pair]
       (defaults 800, 4, 20)
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    mbp = float(args[0]) if len(args) > 0 else 800
    stride = int(args[1]) if len(args) > 1 else 4
    k = int(args[2]) if len(args) > 2 else 20
    if "--pair" in sys.argv:
        os.environ["THERMITE_TABLE_PAIR"] = "1"

    from thermite.seed.native import NativeSmemEngine, available

    assert available(), "native library unavailable"
    n = int(mbp * 1e6)
    rng = np.random.default_rng(99)
    t0 = time.time()
    # integers+take is ~10x rng.choice at Gbp scale (choice draws
    # int64 indices: 8n bytes of temporaries)
    arr = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, n, dtype=np.uint8)
    ]
    print(f"synth {n / 1e6:.0f} Mbp in {time.time() - t0:.1f}s", flush=True)

    t0 = time.time()
    eng = NativeSmemEngine(arr, k, stride=stride)
    dt = time.time() - t0
    npos = (n - k + stride) // stride
    path = "pair" if os.environ.get("THERMITE_TABLE_PAIR") == "1" else "packed"
    print(
        f"{path}: {dt:.1f}s for {npos / 1e6:.0f}M positions = "
        f"{dt * 1e9 / npos:.0f} ns/pos "
        f"(genome 1.6G-pos projection: {dt * 1.6e9 / npos / 60:.1f} min)"
    )
    del eng


if __name__ == "__main__":
    main()
