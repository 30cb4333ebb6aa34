"""Print the fully resolved config.

    python -m nerfdet_tpu_torch.tools.print_config <config> \
        [--options k=v ...]

The port of ``tools/print_config.py`` of the JAX package: the config
after its ``_base_`` files and the ``--options``, one ``key = value``
line a top-level key, the value pretty-printed at width 100.
"""

from __future__ import annotations

import argparse
import pprint
from typing import List, Optional

from ..config import Config


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--options", nargs="+", default=[])
    args = p.parse_args(argv)

    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(args.options)
    for k, v in cfg.to_dict().items():
        print(f"{k} = {pprint.pformat(v, width=100)}")


if __name__ == "__main__":
    main()
