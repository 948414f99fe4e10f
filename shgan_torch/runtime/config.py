"""Model-bank YAML loader (the ``model_cfg_bank`` part of
``shgan_tpu/runtime/config.py:29-180``).

Reads the repository's ``configs/model/*.yaml`` as data, with the same
semantics: ``super_cfg`` single inheritance with ``args`` dict-merge and
``delete_args``; the string macros ``SAME(path)``, ``SEARCH(path)`` and
``MODEL(name)`` resolved recursively.
"""

from __future__ import annotations

import copy
import glob
import os.path as osp

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


def _solve_one(cmd, root, bank):
    if not isinstance(cmd, str):
        return cmd
    if cmd.startswith("SAME"):
        path = [p.strip() for p in cmd[len("SAME"):].strip("()").split(".")]
        try:
            return _solve_one(_lookup(root, path), root, bank)
        except (KeyError, IndexError, TypeError):
            return cmd
    if cmd.startswith("SEARCH"):
        path = [p.strip() for p in cmd[len("SEARCH"):].strip("()").split(".")]
        try:
            return _solve_one(_lookup(root, path), root, bank)
        except (KeyError, IndexError, TypeError):
            pass
        children = (root.values() if isinstance(root, dict)
                    else root if isinstance(root, list) else ())
        for child in children:
            rv = _solve_one(cmd, child, bank)
            if rv != cmd:
                return rv
        return cmd
    if cmd.startswith("MODEL"):
        return bank(cmd[len("MODEL"):].strip("()"))
    return cmd


def cfg_solve(cfg, root, bank):
    """Resolve macros in place through lists and dicts."""
    it = (enumerate(cfg) if isinstance(cfg, list)
          else cfg.items() if isinstance(cfg, dict) else ())
    for k, v in list(it):
        if isinstance(v, (list, dict)):
            cfg[k] = cfg_solve(v, root, bank)
        else:
            cfg[k] = _solve_one(v, root, bank)
    return cfg


def find_config_root():
    """``configs/`` in the working directory or at the repository root."""
    here = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    for cand in ("configs", osp.join(here, "configs")):
        if osp.isdir(cand):
            return osp.abspath(cand)
    raise FileNotFoundError("no configs/ directory found")


class model_cfg_bank:
    """``model_cfg_bank()(name)`` → the solved model config dict."""

    def __init__(self, cfg_root=None):
        self.cfg_dir = osp.join(cfg_root or find_config_root(), "model")
        self.raw = {}
        for path in sorted(glob.glob(osp.join(self.cfg_dir, "*.yaml"))):
            with open(path) as f:
                self.raw.update(yaml.safe_load(f) or {})
        self._solved = {}

    def __call__(self, name):
        if name not in self._solved:
            if name not in self.raw:
                raise KeyError(f"no entry {name!r} in {self.cfg_dir}")
            cfg = Config.wrap(copy.deepcopy(self.raw[name]))
            self._solved[name] = self._resolve(name, cfg)
        return copy.deepcopy(self._solved[name])

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
        return cfg_solve(cfg, cfg, self)
