"""The dry run's serving cells under both layouts, side by side.

``repro_torch.launch.dryrun`` (rank 0 of the production mesh on meta
tensors, a fake process group, no card) records each cell under the
"tp" layout; its CLI has no layout flag, as the JAX package's has none.
This script runs ``dryrun.run_cell`` for the given archs and shapes under
"tp" and "fsdp" and prints, per cell, one JSON line with the status and
the record's memory and roofline sections (predictions for 256 / 512
H100 SXM cards, not measurements):

    PYTHONPATH=src python tools/dryrun_layouts.py --arch llama3.2-3b \\
        --shapes decode_32k,prefill_32k [--mesh multi]

Under "fsdp" the parameters take the fsdp specs; the cache takes the
cache rules under both, so its bytes a rank are the same.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.launch import dryrun


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["llama3.2-3b"])
    ap.add_argument("--shapes", default="decode_32k,prefill_32k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    multi = args.mesh == "multi"
    with dryrun.fake_world(512 if multi else 256):
        for arch in args.arch:
            for shape in args.shapes.split(","):
                for layout in ("tp", "fsdp"):
                    rec = dryrun.run_cell(arch, shape, multi_pod=multi,
                                          layout=layout)
                    print(json.dumps({k: rec.get(k) for k in (
                        "arch", "shape", "mesh", "layout", "status",
                        "error", "lower_s", "memory", "roofline")}),
                          flush=True)


if __name__ == "__main__":
    main()
