"""SLAM CLI (counterpart of isogs_slam_tpu/scripts/splatam.py):

    python -m isogs_slam_tpu_torch.scripts.splatam \\
        isogs_slam_tpu_torch/configs/synthetic/full_res.py [--end-at N]

Loads the experiment config module, seeds, copies the config into the run
directory for provenance, runs SLAM on config["primary_device"] ("cuda"
unless the config or `--device cpu` says otherwise), then evaluates.

Multi-device (config["parallel"]["map_views"] / ["track_tiles"] > 1): one
process per rank,

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m isogs_slam_tpu_torch.scripts.splatam configs/replica/splatam_mc.py

over NCCL when each rank has a card of its own, gloo when the ranks share
one card (or run on the CPU). Rank 0 alone writes the run directory
(checkpoints, metrics_log.csv, eval, runtime stats) and prints the progress
lines; the other ranks hold the same state and wait for it at the end.
Without torch.distributed.run the knobs clamp to one rank and the sharded
programs run on it.
"""
from __future__ import annotations

import argparse
import os
import sys

from ..parallel import dist as pdist
from ..slam.config import (copy_config_for_provenance, inject_defaults,
                           load_experiment_config)
from ..slam.pipeline import SLAM, primary_device
from ..utils.common import seed_everything


def apply_overrides(config: dict, overrides: list[str], defaults=None):
    """Apply `--set a.b.c=value` entries in place (value = Python literal
    when it parses, raw string otherwise). Keys must already exist: a typo
    silently creating a new key would un-ablate the ablation. With
    `defaults` (a function that fills in the runtime defaults, as
    slam.config.inject_defaults), a key the config leaves to its defaults
    counts as existing and is created; the defaults themselves are still
    filled in later, after the overrides, so those derived from other keys
    (the densification size from the image size) follow them."""
    import ast
    import copy
    known = defaults(copy.deepcopy(config)) if defaults else config
    for item in overrides:
        key, sep, raw = item.partition("=")
        if not sep:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node, ref = config, known
        parts = key.strip().split(".")
        for p in parts[:-1]:
            if not isinstance(ref, dict) or p not in ref:
                raise SystemExit(f"--set: no such config path {key!r}")
            ref = ref[p]
            node = node.setdefault(p, {})
        if not isinstance(ref, dict) or parts[-1] not in ref:
            raise SystemExit(f"--set: no such config key {key!r}")
        node[parts[-1]] = value
        print(f"[config] override {key} = {value!r}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("experiment", type=str,
                        help="Path to experiment config .py")
    parser.add_argument("--end-at", type=int, default=None,
                        help="Stop after this frame index (inclusive)")
    parser.add_argument("--no-eval", action="store_true",
                        help="Skip the final evaluation pass")
    parser.add_argument("--device", type=str, default=None,
                        help="Override config['primary_device'] "
                             "(cuda or cpu)")
    parser.add_argument("--set", action="append", default=[],
                        metavar="KEY=VALUE", dest="overrides",
                        help="Override a config entry by dotted path, e.g. "
                             "--set tracking.num_iters=20 "
                             "--set mapping.loss_weights.iso=1.0 "
                             "(value parsed as a Python literal; bare "
                             "strings pass through). Repeatable. Applied "
                             "after the config module loads; a key the "
                             "config leaves to its runtime defaults "
                             "(raster.*, capacity_granule) can be set too. "
                             "Recorded in the provenance copy's "
                             "overrides.txt.")
    args = parser.parse_args(argv)

    config = load_experiment_config(args.experiment)
    apply_overrides(config, args.overrides, defaults=inject_defaults)
    if args.device is not None:
        config["primary_device"] = args.device
    seed_everything(config.get("seed", 0))
    # under torch.distributed.run: join the process group; the ranks other
    # than 0 print nothing further (rank 0 prints the progress lines)
    pdist.init_distributed(primary_device(config))
    main_rank = pdist.is_main()
    stdout = sys.stdout
    if not main_rank:
        sys.stdout = open(os.devnull, "w")
    try:
        return _run(args, config, main_rank)
    finally:
        if not main_rank:
            sys.stdout.close()
            sys.stdout = stdout


def _run(args, config: dict, main_rank: bool):
    results_dir = os.path.join(config["workdir"], config["run_name"])
    if main_rank and not config.get("load_checkpoint", False):
        copy_config_for_provenance(args.experiment, results_dir)
        if args.overrides:
            os.makedirs(results_dir, exist_ok=True)
            with open(os.path.join(results_dir, "overrides.txt"), "w") as f:
                f.write("\n".join(args.overrides) + "\n")

    slam = SLAM(config)
    slam.run(end_at=args.end_at)

    if main_rank and not args.no_eval:
        from ..eval.eval_helpers import eval_sequence
        # with --end-at, only frames the run actually processed are
        # evaluated (untracked poses beyond it are meaningless)
        n_eval = (min(args.end_at + 1, slam.num_frames)
                  if args.end_at is not None else None)
        slam.eval_results = eval_sequence(
            slam.dataset, slam, slam.eval_dir,
            sil_thres=config["mapping"]["sil_thres"],
            mapping_iters=config["mapping"]["num_iters"],
            add_new_gaussians=config["mapping"]["add_new_gaussians"],
            eval_every=config.get("eval_every", 1),
            num_frames=n_eval)
    # the other ranks wait for rank 0's eval before the group closes
    pdist.shutdown()
    return slam


if __name__ == "__main__":
    main()
