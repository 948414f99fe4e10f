"""Config banks and the training-resume reader (port of
``shgan_tpu/runtime/config.py``).

Reads the repository's ``configs/{model,dataset,experiment}/*.yaml`` as
data, with the same semantics: ``super_cfg`` single inheritance (``args``
dict-merge and ``delete_args`` for models, a top-level merge and ``delete``
for datasets); the string macros ``SAME(path)``, ``SEARCH(path)``,
``MODEL(name)`` and ``DATASET(name)`` resolved recursively; experiment
configs solved twice so SEARCH sees expanded values.
"""

from __future__ import annotations

import copy
import glob
import os.path as osp
import re

import yaml


class Config(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [cls.wrap(v) for v in obj]
        return obj


def _lookup(root, path):
    zoom = root
    for pi in path:
        try:
            pi = int(pi)
        except ValueError:
            pass
        zoom = zoom[pi]
    return zoom


def _solve_one(cmd, root, banks):
    if not isinstance(cmd, str):
        return cmd
    if cmd.startswith("SAME"):
        path = [p.strip() for p in cmd[len("SAME"):].strip("()").split(".")]
        try:
            return _solve_one(_lookup(root, path), root, banks)
        except (KeyError, IndexError, TypeError):
            return cmd
    if cmd.startswith("SEARCH"):
        path = [p.strip() for p in cmd[len("SEARCH"):].strip("()").split(".")]
        try:
            return _solve_one(_lookup(root, path), root, banks)
        except (KeyError, IndexError, TypeError):
            pass
        children = (root.values() if isinstance(root, dict)
                    else root if isinstance(root, list) else ())
        for child in children:
            rv = _solve_one(cmd, child, banks)
            if rv != cmd:
                return rv
        return cmd
    if cmd.startswith("MODEL"):
        return banks["model"](cmd[len("MODEL"):].strip("()"))
    if cmd.startswith("DATASET"):
        return banks["dataset"](cmd[len("DATASET"):].strip("()"))
    return cmd


def cfg_solve(cfg, root, banks):
    """Resolve macros in place through lists and dicts; ``banks`` maps
    'model' / 'dataset' to the banks the MODEL / DATASET macros read."""
    it = (enumerate(cfg) if isinstance(cfg, list)
          else cfg.items() if isinstance(cfg, dict) else ())
    for k, v in list(it):
        if isinstance(v, (list, dict)):
            cfg[k] = cfg_solve(v, root, banks)
        else:
            cfg[k] = _solve_one(v, root, banks)
    return cfg


def find_config_root():
    """``configs/`` in the working directory or at the repository root."""
    here = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    for cand in ("configs", osp.join(here, "configs")):
        if osp.isdir(cand):
            return osp.abspath(cand)
    raise FileNotFoundError("no configs/ directory found")


class _Bank:
    """``bank(name)`` → a deep copy of the solved entry ``name``."""

    subdir = None

    def __init__(self, cfg_root=None):
        self.cfg_root = cfg_root or find_config_root()
        self.cfg_dir = osp.join(self.cfg_root, self.subdir)
        self.raw = {}
        self._solved = {}
        self._load_all()

    def _load_all(self):
        for path in sorted(glob.glob(osp.join(self.cfg_dir, "*.yaml"))):
            with open(path) as f:
                self.raw.update(yaml.safe_load(f) or {})

    def banks(self):
        return {"model": model_cfg_bank(self.cfg_root),
                "dataset": dataset_cfg_bank(self.cfg_root)}

    def __call__(self, name):
        if name not in self._solved:
            if name not in self.raw:
                raise KeyError(f"no entry {name!r} in {self.cfg_dir}")
            cfg = Config.wrap(copy.deepcopy(self.raw[name]))
            self._solved[name] = self._resolve(name, cfg)
        return copy.deepcopy(self._solved[name])

    def _resolve(self, name, cfg):
        raise NotImplementedError


class model_cfg_bank(_Bank):
    subdir = "model"

    def banks(self):
        return {"model": self, "dataset": dataset_cfg_bank(self.cfg_root)}

    def _resolve(self, name, cfg):
        cfg["name"] = name
        if cfg.get("super_cfg"):
            sup = self(cfg.pop("super_cfg"))
            if "args" in cfg:
                sup.setdefault("args", Config()).update(cfg.pop("args"))
            sup.update(cfg)
            cfg = sup
            for d in cfg.pop("delete_args", []) or []:
                cfg["args"].pop(d, None)
        cfg.pop("super_cfg", None)
        return cfg_solve(cfg, cfg, self.banks())


class dataset_cfg_bank(_Bank):
    subdir = "dataset"

    def banks(self):
        return {"model": model_cfg_bank(self.cfg_root), "dataset": self}

    def _resolve(self, name, cfg):
        cfg["name"] = name
        if cfg.get("super_cfg"):
            sup = self(cfg.pop("super_cfg"))
            sup.update(cfg)
            cfg = sup
            for d in cfg.pop("delete", []) or []:
                cfg.pop(d, None)
        cfg.pop("super_cfg", None)
        return cfg_solve(cfg, cfg, self.banks())


class experiment_cfg_bank(_Bank):
    """One file per experiment, whose top level is the config."""

    subdir = "experiment"

    def _load_all(self):
        for path in sorted(glob.glob(osp.join(self.cfg_dir, "*.yaml"))):
            name = osp.splitext(osp.basename(path))[0]
            with open(path) as f:
                self.raw[name] = yaml.safe_load(f) or {}

    def _resolve(self, name, cfg):
        cfg["name"] = name
        banks = self.banks()
        cfg = cfg_solve(cfg, cfg, banks)
        return cfg_solve(cfg, cfg, banks)  # twice so SEARCH sees expansions


def load_resume_run(resume_path, resume_itern=None):
    """Reconstruct a training run from its dumped ``config.yaml``:
    ``resume_path`` may be the run's log dir (the one holding
    ``config.yaml``), its ``weight/`` dir or a snapshot dir inside it.  The
    snapshot picked is the one of ``resume_itern`` (kimg), else the one
    named, else the latest ``network-snapshot-<kimg>``.  The run continues
    in the dir pointed at.  Returns ``(cfg, snapshot_path)``."""
    rp = osp.abspath(resume_path)
    run_dir = None
    for cand in (rp, osp.dirname(rp), osp.dirname(osp.dirname(rp))):
        if osp.isfile(osp.join(cand, "config.yaml")):
            run_dir = cand
            break
    if run_dir is None:
        raise FileNotFoundError(
            f"no config.yaml at or above {resume_path!r}: --resume_path "
            "must point into a run dir whose launch dumped its config")
    with open(osp.join(run_dir, "config.yaml")) as f:
        cfg = Config.wrap(yaml.safe_load(f))
    if cfg.get("train") is None:
        raise ValueError(f"{run_dir}/config.yaml has no train section")
    cfg["train"]["log_dir"] = run_dir
    weight_dir = osp.join(run_dir, "weight")
    if resume_itern is not None:
        snap = osp.join(weight_dir,
                        "network-snapshot-{:06d}".format(resume_itern))
        if not osp.exists(snap):
            raise FileNotFoundError(snap)
    elif rp != run_dir and osp.basename(rp).startswith("network-snapshot"):
        snap = rp
    else:
        snaps = sorted(
            p for p in glob.glob(osp.join(weight_dir, "network-snapshot-*"))
            if re.fullmatch(r"network-snapshot-\d+", osp.basename(p)))
        if not snaps:
            raise FileNotFoundError(f"no network-snapshot-* under "
                                    f"{weight_dir}")
        snap = snaps[-1]
    return cfg, snap


def apply_debug_shrink(cfg):
    """--debug: tiny batches, few samples, no workers, no demo grid."""
    for sec in ("train", "eval"):
        if cfg.get(sec):
            cfg[sec]["batch_size_per_gpu"] = 2
            cfg[sec]["dataset_num_workers_per_gpu"] = 0
            if cfg[sec].get("dataset") is not None:
                cfg[sec]["dataset"]["try_sample"] = 32
            cfg[sec]["output_sample_images"] = False
    if cfg.get("train"):
        cfg["train"]["total_kimg"] = 0.08
        cfg["train"]["kimg_per_tick"] = 0.02
        cfg["train"]["snapshot_ticks"] = 2
    if cfg.get("env") is not None:
        cfg["env"]["debug"] = True
    return cfg
