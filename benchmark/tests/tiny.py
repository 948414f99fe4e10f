"""A benchmark tree with tiny cells for the CPU tests: the real manifest's
files, and beside them a tiny SH-GAN configuration and one tiny cell of
each serving mix."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(BENCH) else len(sys.path), p)


def tiny_model():
    """shgan_g512's configuration at a tiny channel plan and 32x32."""
    cfg = json.loads((BENCH / "configs" / "shgan_g512.json").read_text())
    m = copy.deepcopy(cfg["model"])
    a = m["args"]
    a["mapping"]["args"].update(z_dim=16, w_dim=16, num_ws=8)
    a["encoder"]["args"].update(resolution=32, ch_base=64, ch_max=16, oc_n=16,
                                shu_input_res=16, shu_channels=4)
    a["synthesis"]["args"].update(resolution=32, ch_base=64, ch_max=16,
                                  w_dim=16, w0_dim=16)
    return m


def tiny_train():
    """shgan_ffhq256_train at the tiny channel plan, 32x32, 32 images."""
    cfg = json.loads((BENCH / "configs" / "shgan_ffhq256_train.json")
                     .read_text())
    cfg["model_g"] = tiny_model()
    cfg["model_d"]["args"].update(resolution=32, ch_base=64, ch_max=16)
    cfg["train"]["num_workers"] = 2
    return cfg


def tree(tmp, rate=40.0):
    """A copy of the benchmark's files under ``tmp`` with the tiny
    configuration ``tiny`` and the cells ``tiny-stream`` and
    ``tiny-interactive``; returns (root, manifest)."""
    root = Path(tmp) / "benchmark"
    for sub in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "shgan_g512.json").read_text())
    cfg.update(name="tiny", model=tiny_model())
    (root / "configs" / "tiny.json").write_text(json.dumps(cfg))
    limits = {"kept_px_changed": 0, "hole_px_off_pct": 0.5,
              "hole_rms_levels": 0.5}
    (root / "workloads" / "tiny-stream.json").write_text(json.dumps(
        {"check_batches": 2, "traffic": {"batch": 2, "pool": 4},
         "limits": limits}))
    (root / "workloads" / "tiny-interactive.json").write_text(json.dumps(
        {"check_per_bucket": 1,
         "traffic": {"rate_per_s": rate, "max_size": 4, "p": 0.5,
                     "buckets": [1, 2], "pool": 4},
         "limits": limits}))
    tcfg = tiny_train()
    tcfg["name"] = "tiny_train"
    (root / "configs" / "tiny_train.json").write_text(json.dumps(tcfg))
    (root / "workloads" / "tiny-train.json").write_text(json.dumps(
        {"traffic": {"images": 32},
         "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3,
                    "change_gap": 1e-3}}))
    manifest["configs"].append({"name": "tiny_train", "source": "a test",
                                "file": "benchmark/configs/tiny_train.json",
                                "reduced": [], "why": "CPU tests"})
    manifest["configs"].append({"name": "tiny", "source": "a test",
                                "file": "benchmark/configs/tiny.json",
                                "reduced": [], "why": "CPU tests"})
    manifest["workloads"] += [
        {"name": "tiny-stream", "config": "tiny", "traffic": "stream-b8",
         "chips": 1, "why": "CPU test"},
        {"name": "tiny-interactive", "config": "tiny",
         "traffic": "interactive-one", "chips": 1, "why": "CPU test"},
        {"name": "tiny-train", "config": "tiny_train", "traffic": "train-b8",
         "chips": 1, "why": "CPU test"}]
    # the open loop's measure, for the tiny cell that drives it
    manifest["end_to_end"].insert(0, {
        "name": "serve_p95_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tiny-interactive"]})
    tiny_of = {"g512-stream-b8": "tiny-stream",
               "g256-train-b8": "tiny-train"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [tiny_of[w] for w in m["workloads"]
                               if w in tiny_of]
    return root, manifest
