"""Command line of the port: the eval stage, with the eval flags of the JAX
package's ``main.py``::

    python -m shgan_torch.main --experiment shgan_synthetic256_eval \\
        [--debug] [--eval ID] [--seed N] [--pretrained path.pth] \\
        [--eval_tag TAG] [--model NAME] [--dataset NAME] [--pick UID ...] \\
        [--demo] [--gpu 0] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given.  Training
(``--resume_path``, ``--trainonly``, experiments without an eval section)
comes with the training slice and raises.  Logs go to
``<SHGAN_LOG_ROOT or env.log_root_dir>/<model>_<dataset>/<id>/<eval_tag>/``
with ``eval.log``, the solved ``config.yaml`` and ``result.json``.
"""

from __future__ import annotations

import argparse
import copy
import os
import os.path as osp
import time

import yaml

from .runtime.config import (apply_debug_shrink, dataset_cfg_bank,
                             experiment_cfg_bank, model_cfg_bank)
from .runtime.logging import print_log, set_log_file

TRAINING_LATER = "training comes with the training slice"


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m shgan_torch.main",
        description="Evaluate an SH-GAN inpainting generator (PyTorch).")
    p.add_argument("--experiment", type=str, default=None,
                   help="experiment-bank name")
    p.add_argument("--debug", action="store_true",
                   help="tiny batches and samples, synthetic data fallback")
    p.add_argument("--eval", type=int, default=None,
                   help="run eval, tagging the run with this id")
    p.add_argument("--gpu", nargs="+", type=int, default=None,
                   help="device indices; one device only in this slice")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--pretrained", type=str, default=None,
                   help="override eval.pretrained_pth")
    p.add_argument("--ckpt", type=str, default=None,
                   help="alias of --pretrained")
    p.add_argument("--eval_tag", type=str, default=None)
    p.add_argument("--demo", action="store_true",
                   help="write the demo image grid and exit")
    p.add_argument("--dataset", type=str, default=None,
                   help="swap in a dataset from the dataset bank")
    p.add_argument("--model", type=str, default=None,
                   help="swap in a generator from the model bank")
    p.add_argument("--pick", nargs="+", type=str, default=None,
                   help="restrict eval to these unique_ids")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the kernels' plain versions; default "
                        "the CUDA device")
    p.add_argument("--resume_path", type=str, default=None,
                   help=TRAINING_LATER)
    p.add_argument("--trainonly", action="store_true", help=TRAINING_LATER)
    return p.parse_args(argv)


def build_config(experiment, debug=False, eval_id=None, seed=None,
                 pretrained=None, eval_tag=None, model=None, dataset=None,
                 pick=None, demo=False, gpu=None, log_root=None):
    """The solved eval config of ``experiment`` with the CLI's overrides
    applied, and its log dir set (and created):
    ``<log_root>/<model>_<dataset>/<eval id>/<eval tag>``.  ``log_root``
    defaults to ``SHGAN_LOG_ROOT``, else the config's ``env.log_root_dir``.
    """
    cfg = experiment_cfg_bank()(experiment)
    if model is not None:
        cfg["model_g"] = model_cfg_bank()(model)
        cfg["model"] = {"symbol": model.split("_")[0]}
    if dataset is not None:
        ds = dataset_cfg_bank()(dataset)
        for sec in ("train", "eval"):
            if cfg.get(sec) is not None:
                cfg[sec]["dataset"] = copy.deepcopy(ds)
    if cfg.get("eval") is None or (cfg.get("train") is not None
                                   and eval_id is None and not demo):
        raise NotImplementedError(
            f"experiment [{experiment}] trains: {TRAINING_LATER} (pass "
            "--eval ID to evaluate an experiment that has an eval section)")
    if pick is not None:
        cfg["eval"]["dataset"]["pick"] = list(pick)
    cfg.pop("train", None)
    if eval_id is not None:
        cfg["eval"]["experiment_id"] = eval_id
    if seed is not None:
        cfg["env"]["rnd_seed"] = seed
    if gpu is not None:
        cfg["env"]["mesh_devices"] = len(gpu)
    if debug:
        cfg = apply_debug_shrink(cfg)
    if pretrained is not None:
        cfg["eval"]["pretrained_pth"] = pretrained
    if eval_tag is not None:
        cfg["eval"]["eval_tag"] = eval_tag
    if demo:
        cfg["eval"]["output_sample_images"] = True
        cfg["eval"]["demo_only"] = True

    expid = cfg["eval"].get("experiment_id")
    if expid is None:  # 0 is a legitimate id (--eval 0)
        expid = int(time.time() * 100)
    model_sym = cfg.get("model", {}).get("symbol", "model")
    ds_name = cfg["eval"]["dataset"].get("name", "dataset")
    tag = cfg["eval"].get("eval_tag", "eval")
    log_root = (log_root or os.environ.get("SHGAN_LOG_ROOT")
                or cfg["env"].get("log_root_dir", "log"))
    log_dir = osp.join(log_root, f"{model_sym}_{ds_name}", str(expid), tag)
    os.makedirs(log_dir, exist_ok=True)
    cfg["eval"]["log_dir"] = log_dir
    return cfg


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def run(cfg, device=None):
    """Tee the log into the run's log dir, dump the solved config and run
    the eval stage; returns its result."""
    from .runtime.stages import eval_stage
    log_dir = cfg["eval"]["log_dir"]
    set_log_file(osp.join(log_dir, "eval.log"))
    try:
        with open(osp.join(log_dir, "config.yaml"), "w") as f:
            yaml.safe_dump(_plain(cfg), f, sort_keys=False)
        print_log(f"experiment: {cfg.get('name')}  stage: eval")
        print_log(f"log_dir: {log_dir}")
        rv = eval_stage()(cfg, device=device)
        print_log("done.")
        return rv
    finally:
        set_log_file(None)


def main(argv=None):
    args = get_args(argv)
    if args.resume_path is not None or args.trainonly:
        raise SystemExit(f"--resume_path / --trainonly: {TRAINING_LATER}")
    if args.experiment is None:
        raise SystemExit("--experiment is required")
    cfg = build_config(
        args.experiment, debug=args.debug, eval_id=args.eval,
        seed=args.seed, pretrained=args.pretrained or args.ckpt,
        eval_tag=args.eval_tag, model=args.model, dataset=args.dataset,
        pick=args.pick, demo=args.demo, gpu=args.gpu)
    return run(cfg, device=args.device)


if __name__ == "__main__":
    main()
