"""Prepare a checkpoint of the port for release.

    python -m nerfdet_tpu_torch.tools.publish_model <in.pth> <out_dir>

The port of ``tools/publish_model.py`` of the JAX package: the model's
state of a checkpoint the port's train CLI wrote, without the optimizer's
state, saved as ``out_dir/ckpt_0.pth`` with the step in its meta, then
renamed with the first 8 hex digits of the SHA-256 of the tensors' bytes
(in ``state_dict`` order) appended to the file name; prints ``{"path",
"sha256"}``. ``api.init_detector`` loads the published file.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from typing import Dict, List, Optional

from ..utils.checkpoint import load_checkpoint, save_checkpoint


def state_digest(state: Dict) -> str:
    """The first 8 hex digits of the SHA-256 of the tensors' bytes, in the
    order of ``state``."""
    h = hashlib.sha256()
    for t in state.values():
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:8]


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser()
    p.add_argument("in_ckpt")
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    ckpt = load_checkpoint(args.in_ckpt)
    published = {"model": ckpt["model"]}
    digest = state_digest(published["model"])
    path = save_checkpoint(args.out_dir, 0, published,
                           meta=dict(sha256=digest,
                                     step=int(ckpt.get("step", 0))))
    final = path + f"-{digest}"
    os.rename(path, final)
    out = dict(path=final, sha256=digest)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
