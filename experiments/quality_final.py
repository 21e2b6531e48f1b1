#!/usr/bin/env python
"""Final quality artifact: run the champion recipe with refine + timings.

Runs ``run_quality_suite`` for the chosen sweep variant (default: the
round-3 champion) with ``refine=True`` and ``measure_times=True`` so the
output carries every arm the VERDICT asks for — simple / post / refined /
randomized / refined_random + amortized stage timings — and writes
``docs/quality_r3.json``.

Usage: python experiments/quality_final.py [variant] [output.json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quality_sweep import VARIANTS  # noqa: E402  (sibling module)

from gcn_maxcut.bench.quality import run_quality_suite  # noqa: E402


def main():
    variant = sys.argv[1] if len(sys.argv) > 1 else "ent05"
    out_path = sys.argv[2] if len(sys.argv) > 2 else "docs/quality_r3.json"
    kw = VARIANTS[variant]
    print(f"[final] variant {variant}: {kw}", flush=True)
    out = run_quality_suite(recipe="mixed", refine=True, measure_times=True, **kw)
    out["variant"] = variant
    out["variant_kwargs"] = kw
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2, default=str)
    print(f"[final] wrote {out_path}", flush=True)
    print(json.dumps(
        {s: {k: v[k] for k in ("simple", "post", "refined", "randomized",
                               "refined_random")}
         for s, v in out["per_size"].items()}, indent=1, default=str))


if __name__ == "__main__":
    main()
