"""Train just the acting+stabilizing policy pair for one task (the protocol
eval's training legs, nothing else), so its weights can be examined before
the 3-stage eval protocol runs on them. Counterpart of ``tools/train_pair.py``.

Run:  python3 -m voxactb_tpu_torch.tools.train_pair --task open_drawer \\
          --out build/protocol_eval --iters 6000 --save-freq 2000 [--device cuda]
"""

from __future__ import annotations

import argparse
import os

from voxactb_tpu_torch.tools.run_protocol_eval import train_policy


def main(argv=None, device=None):
    """Train the pair; returns ``{arm: seed_dir}``. ``device`` overrides
    ``--device`` (default cuda; raises without it)."""
    from voxactb_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--task", required=True)
    ap.add_argument("--out", default="build/protocol_eval")
    ap.add_argument("--iters", type=int, default=6000)
    ap.add_argument("--save-freq", type=int, default=2000)
    ap.add_argument("--demos", type=int, default=10)
    ap.add_argument("--device", default=None)
    ap.add_argument("--extra", nargs="*", default=[])
    args = ap.parse_args(argv)
    device = resolve_device(device if device is not None else args.device)
    root = os.path.join(args.out, args.task)
    os.makedirs(root, exist_ok=True)
    return {arm: train_policy(args.task, arm, root, args.iters, args.demos,
                              args.save_freq, args.extra, device)
            for arm in ("dominant", "assistive")}


if __name__ == "__main__":
    main()
