"""Command line of the port: the eval and train stages, with the flags of
the JAX package's ``main.py``::

    python -m shgan_torch.main --experiment shgan_synthetic256_eval \\
        [--debug] [--eval ID] [--seed N] [--pretrained path.pth] \\
        [--eval_tag TAG] [--model NAME] [--dataset NAME] [--pick UID ...] \\
        [--demo] [--gpu 0 [1 ...]] [--device cpu] [--evalnog_path GEN_DIR]
    python -m shgan_torch.main --experiment smoke_train [--trainonly] \\
        [--resume_path SNAPSHOT [--resume_itern KIMG]] [--device cpu] \\
        [--signature TAG ...] [--dscache [X]] [--port N]
    python -m shgan_torch.main --resume_path RUN_DIR   # continue that run

An experiment with a train section trains unless ``--eval ID`` or
``--demo`` asks for its eval section; a training run keeps the eval
section for its nested eval (``train.eval_every_kimg``).
``--evalnog_path GEN_DIR`` scores
the images in ``GEN_DIR`` (``<uid>.png``) against the eval dataset's reals
with no generator in the loop.  It runs on the CUDA device unless
``--device cpu`` is given.  Logs go to
``<SHGAN_LOG_ROOT or env.log_root_dir>/<model>_<dataset>/<id>/<tag>/``
(``<tag>`` the eval tag, or ``train``) with ``eval.log`` or ``train.log``
and the solved ``config.yaml``; eval writes ``result.json``, training
``stats.jsonl`` and ``weight/network-snapshot-<kimg>/``.  ``--signature``
suffixes the run id (``<id>_<sig1>_<sig2>``), ``--dscache`` keeps the
datasets' decoded elements in memory, ``--port`` is accepted and unused.
Outside ``--debug`` the run's log dir gets a copy of ``shgan_torch/`` and
``configs/`` under ``code/`` (``env.code_snapshot: false`` turns it off).

Several devices: ``--gpu 0 1`` starts one process per entry
(``torch.multiprocessing.spawn``), rank r on ``cuda:<entry r>`` (``--gpu 0
0``: two ranks on one card, over gloo; with ``--device cpu`` the ranks run
on the CPU), meeting at ``127.0.0.1:<--port>`` (default a free port).
Without ``--gpu``, torchrun's variables or ``SHGAN_DIST_COORDINATOR`` /
``SHGAN_DIST_NPROCS`` / ``SHGAN_DIST_PID`` make this process one rank.
The lead picks the run id and writes the logs; any rank's failure is a
nonzero exit.
"""

from __future__ import annotations

import argparse
import copy
import os
import os.path as osp
import shutil
import socket
import sys
import time

import yaml

from .parallel import multihost
from .runtime.config import (apply_debug_shrink, dataset_cfg_bank,
                             experiment_cfg_bank, load_resume_run,
                             model_cfg_bank)
from .runtime.logging import print_log, set_log_file


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
                   help="device indices, one rank (process) each")
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
                   help="a training snapshot to resume; alone, a run dir "
                        "whose config.yaml is re-read and continued")
    p.add_argument("--resume_itern", type=int, default=None,
                   help="the snapshot's kimg (picks it; sets the progress)")
    p.add_argument("--trainonly", action="store_true",
                   help="drop the eval section")
    p.add_argument("--evalnog_path", type=str, default=None,
                   help="evaluate pre-generated images from this dir "
                        "(no generator in the loop)")
    p.add_argument("--signature", nargs="+", type=str, default=None,
                   help="suffixes of the run id")
    p.add_argument("--dscache", nargs="?", const=True, default=None,
                   help="keep the datasets' decoded elements in memory "
                        "(bare, or with a value as the JAX CLI takes it)")
    p.add_argument("--port", type=int, default=None,
                   help="the ranks' rendezvous port on 127.0.0.1 for --gpu "
                        "with several devices (default: a free port)")
    return p.parse_args(argv)


def _set(cfg, dotted, value):
    *path, last = dotted.split(".")
    node = cfg
    for k in path:
        node = node[k]
    node[last] = value


def set_evalnog_path(ds, gen_dir):
    """The eval dataset dict that pairs ``ds``'s reals with the images in
    ``gen_dir``: a ``*loadgen`` type gets ``args.gen_dir``; a type with a
    loadgen form becomes it; any other is wrapped in a ``loadgen`` over
    it.  ``ds`` is changed in place where it can be; returns the dict."""
    from .data.datasets import _DATASET_REGISTRY
    if str(ds.get("type", "")).endswith("loadgen"):
        ds.setdefault("args", {})["gen_dir"] = gen_dir
        return ds
    ds["gen_dir"] = gen_dir
    loadgen_type = f"{ds['type']}_loadgen"
    if loadgen_type in _DATASET_REGISTRY:
        ds["type"] = loadgen_type
        ds.setdefault("args", {})["gen_dir"] = gen_dir
        return ds
    return {"type": "loadgen", "name": ds.get("name"), "gen_dir": gen_dir,
            "args": {"base": dict(ds), "gen_dir": gen_dir},
            "formatter": ds.get("formatter")}


def build_config(experiment, debug=False, eval_id=None, seed=None,
                 pretrained=None, eval_tag=None, model=None, dataset=None,
                 pick=None, demo=False, gpu=None, log_root=None,
                 trainonly=False, resume_path=None, resume_itern=None,
                 evalnog_path=None, signature=None, dscache=False,
                 overrides=None):
    """The solved config of ``experiment`` with the CLI's overrides
    applied, for its eval section (``eval_id``/``demo`` given, or no train
    section) or else its train section, and that section's log dir set
    (and created): ``<log_root>/<model>_<dataset>/<id>/<eval tag or
    "train">``, ``<id>`` suffixed with each of ``signature``.  An eval run
    drops the train section; a training run keeps the eval section (the
    nested eval reads it).  ``dscache`` sets ``cache: true`` on both
    sections' datasets.  ``log_root`` defaults to ``SHGAN_LOG_ROOT``, else the
    config's ``env.log_root_dir``.  ``overrides`` maps dotted keys
    (``"train.total_kimg"``) to values, applied last."""
    cfg = experiment_cfg_bank()(experiment)
    if model is not None:
        cfg["model_g"] = model_cfg_bank()(model)
        cfg["model"] = {"symbol": model.split("_")[0]}
    if dataset is not None:
        ds = dataset_cfg_bank()(dataset)
        for sec in ("train", "eval"):
            if cfg.get(sec) is not None:
                cfg[sec]["dataset"] = copy.deepcopy(ds)
    if trainonly:
        cfg.pop("eval", None)
    is_eval = eval_id is not None or demo or cfg.get("train") is None
    section = "eval" if is_eval else "train"
    if cfg.get(section) is None:
        raise SystemExit(f"experiment [{experiment}] has no {section} "
                         "section to run")
    if is_eval:
        cfg.pop("train", None)
    if resume_path is not None:
        if is_eval:
            raise SystemExit(f"--resume_path given but experiment "
                             f"[{experiment}] has no train section to run")
        cfg["train"]["resume_path"] = resume_path
        if resume_itern is not None:
            cfg["train"]["resume_itern"] = resume_itern
    if pick is not None and is_eval:
        cfg["eval"]["dataset"]["pick"] = list(pick)
    if eval_id is not None:
        cfg["eval"]["experiment_id"] = eval_id
    if seed is not None:
        cfg["env"]["rnd_seed"] = seed
    if gpu is not None:
        cfg["env"]["mesh_devices"] = len(gpu)
    if debug:
        cfg = apply_debug_shrink(cfg)
    for flag, val in (("--pretrained", pretrained), ("--eval_tag", eval_tag),
                      ("--evalnog_path", evalnog_path)):
        if val is not None and not is_eval:
            raise SystemExit(f"{flag} needs an eval run; [{experiment}] "
                             "trains")
    if pretrained is not None:
        cfg["eval"]["pretrained_pth"] = pretrained
    if eval_tag is not None:
        cfg["eval"]["eval_tag"] = eval_tag
    if evalnog_path is not None:
        cfg["eval"]["dataset"] = set_evalnog_path(cfg["eval"]["dataset"],
                                                  evalnog_path)
    if demo:
        cfg["eval"]["output_sample_images"] = True
        cfg["eval"]["demo_only"] = True
    if dscache:
        for sec in ("train", "eval"):
            if cfg.get(sec) and cfg[sec].get("dataset") is not None:
                cfg[sec]["dataset"]["cache"] = True
    for k, v in (overrides or {}).items():
        _set(cfg, k, v)

    sec = cfg[section]
    expid = sec.get("experiment_id")
    if expid is None:  # 0 is a legitimate id (--eval 0)
        # the lead's clock: every rank writes under one id
        expid = multihost.broadcast_object(int(time.time() * 100))
    if signature:
        expid = f"{expid}_{'_'.join(signature)}"
    model_sym = cfg.get("model", {}).get("symbol", "model")
    ds_name = sec["dataset"].get("name", "dataset")
    tag = sec.get("eval_tag", "eval") if is_eval else "train"
    log_root = (log_root or os.environ.get("SHGAN_LOG_ROOT")
                or cfg["env"].get("log_root_dir", "log"))
    log_dir = osp.join(log_root, f"{model_sym}_{ds_name}", str(expid), tag)
    os.makedirs(log_dir, exist_ok=True)
    sec["log_dir"] = log_dir
    return cfg


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def snapshot_code(log_dir):
    """Copy ``shgan_torch/`` and ``configs/`` into ``<log_dir>/code`` (once
    a run dir), so a run keeps the code it ran."""
    dst = osp.join(log_dir, "code")
    if osp.exists(dst):
        return
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    for item in ("shgan_torch", "configs"):
        shutil.copytree(osp.join(root, item), osp.join(dst, item),
                        ignore=shutil.ignore_patterns("__pycache__"))


def run(cfg, device=None, **stage_kw):
    """Tee the log into the run's log dir, dump the solved config and run
    the train stage (a config with a train section) or the eval stage;
    returns its result."""
    from .runtime.stages import eval_stage, train_stage
    section = "train" if cfg.get("train") is not None else "eval"
    log_dir = cfg[section]["log_dir"]
    lead = multihost.is_lead()
    if lead:
        set_log_file(osp.join(log_dir, f"{section}.log"))
    try:
        if lead:
            with open(osp.join(log_dir, "config.yaml"), "w") as f:
                yaml.safe_dump(_plain(cfg), f, sort_keys=False)
        print_log(f"experiment: {cfg.get('name')}  stage: {section}")
        print_log(f"log_dir: {log_dir}")
        stage = train_stage() if section == "train" else eval_stage()
        rv = stage(cfg, device=device, **stage_kw)
        print_log("done.")
        return rv
    finally:
        set_log_file(None)


def resume_config(resume_path, resume_itern=None, seed=None, gpu=None,
                  debug=False):
    """``--resume_path`` alone: the run's own solved ``config.yaml``,
    continued in its log dir from the snapshot picked
    (:func:`~.runtime.config.load_resume_run`)."""
    cfg, snap = load_resume_run(resume_path, resume_itern)
    if seed is not None:
        cfg["env"]["rnd_seed"] = seed
    if gpu is not None:
        cfg["env"]["mesh_devices"] = len(gpu)
    if debug:
        cfg = apply_debug_shrink(cfg)
    cfg["train"]["resume_path"] = snap
    if resume_itern is not None:
        cfg["train"]["resume_itern"] = resume_itern
    os.makedirs(cfg["train"]["log_dir"], exist_ok=True)
    return cfg


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, argv, world, port):
    """One rank started by ``--gpu``: join the group, then run ``main``."""
    os.environ.update(SHGAN_DIST_COORDINATOR=f"127.0.0.1:{port}",
                      SHGAN_DIST_NPROCS=str(world), SHGAN_DIST_PID=str(rank))
    main(argv)


def rank_device(args):
    """This process's device: ``--device``, else ``cuda:<--gpu entry of
    its rank>``, else the rank's by :func:`~.parallel.rank_device` (None
    without a process group: the stages pick the CUDA device)."""
    if args.device is not None:
        return args.device
    env = multihost.dist_env()
    rank = env[2] if env is not None else 0
    if args.gpu is not None:
        return f"cuda:{args.gpu[rank]}"
    if env is not None:
        return str(multihost.rank_device(rank, env[3]))
    return None


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    if (args.gpu is not None and len(args.gpu) > 1
            and multihost.dist_env() is None):
        import torch.multiprocessing as mp
        port = args.port or _free_port()
        # a rank that raises makes spawn raise (and stops the others)
        mp.spawn(_rank_main, args=(argv, len(args.gpu), port),
                 nprocs=len(args.gpu), join=True)
        return None
    device = rank_device(args)
    multihost.maybe_initialize_distributed(device=device)
    try:
        return _main(args, device)
    finally:
        if multihost.world_size() > 1:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, device):
    if (args.resume_path is not None and args.eval is None
            and args.experiment is None):
        cfg = resume_config(args.resume_path, args.resume_itern,
                            seed=args.seed, gpu=args.gpu, debug=args.debug)
        return run(cfg, device=device)
    if args.experiment is None:
        raise SystemExit("--experiment is required (or --resume_path to "
                         "continue a saved run)")
    cfg = build_config(
        args.experiment, debug=args.debug, eval_id=args.eval,
        seed=args.seed, pretrained=args.pretrained or args.ckpt,
        eval_tag=args.eval_tag, model=args.model, dataset=args.dataset,
        pick=args.pick, demo=args.demo, gpu=args.gpu,
        trainonly=args.trainonly, resume_path=args.resume_path,
        resume_itern=args.resume_itern, evalnog_path=args.evalnog_path,
        signature=args.signature, dscache=args.dscache is not None)
    if (not args.debug and cfg["env"].get("code_snapshot", True)
            and multihost.is_lead()):
        section = "train" if cfg.get("train") is not None else "eval"
        snapshot_code(cfg[section]["log_dir"])
    return run(cfg, device=device)


if __name__ == "__main__":
    main()
