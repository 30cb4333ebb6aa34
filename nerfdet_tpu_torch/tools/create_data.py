"""Write a synthetic dataset in ScanNet's on-disk layout.

    python -m nerfdet_tpu_torch.tools.create_data synthetic \
        --root-path data/synthetic [--n-scenes 4] [--n-images 20] \
        [--hw 240 320] [--splits train val] [--seed 0] [--workers 1]

The counterpart of ``tools/create_data.py synthetic`` of the JAX
package (``data/synthetic.write_synthetic_scannet``: PNG views,
``points/*.bin`` and ``scannet_infos_{split}.pkl``), without depth maps.
The converters of real datasets are not ported; the info files the JAX
package's ScanNet converter writes are plain pickles the port reads.
"""

from __future__ import annotations

import argparse
import time

from ..data.synthetic import write_synthetic_scannet


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Data converter")
    p.add_argument("dataset", choices=["synthetic"])
    p.add_argument("--root-path", required=True)
    p.add_argument("--n-scenes", type=int, default=4,
                   help="scenes per split")
    p.add_argument("--n-images", type=int, default=20,
                   help="views per scene")
    p.add_argument("--hw", type=int, nargs=2, default=(240, 320),
                   help="view height and width (the intrinsic is at this "
                        "size, as ScanNet's is at its sensor's)")
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=1,
                   help="processes rendering the views")
    return p.parse_args(argv)


def main(argv=None) -> str:
    args = parse_args(argv)
    t0 = time.perf_counter()
    root = write_synthetic_scannet(
        args.root_path, n_scenes=args.n_scenes, n_images=args.n_images,
        hw=tuple(args.hw), seed=args.seed, splits=tuple(args.splits),
        workers=args.workers)
    print(f"[synthetic] wrote {args.n_scenes} scene(s) x {args.n_images} "
          f"views of {args.hw[0]}x{args.hw[1]} for {list(args.splits)} -> "
          f"{root} in {time.perf_counter() - t0:.1f} s")
    return root


if __name__ == "__main__":
    main()
