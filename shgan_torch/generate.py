"""Batch-generate inpainted images for an experiment's eval dataset: the
producer side of the ``--evalnog_path`` protocol (port of
``tools/generate.py``).  The experiment's eval set runs through
:class:`~.serve.InpaintEngine` and each composite is written as
``<uid>.png``::

    python -m shgan_torch.generate --experiment shgan_ffhq256_eval \\
        --pretrained pretrained/shgan_ffhq256.pth --out gen/ [--bf16]
    # then score it, with no generator in the loop:
    python -m shgan_torch.main --experiment shgan_ffhq256_eval --eval 1 \\
        --evalnog_path gen/

The masks come from the same per-position stream as a metric run over the
same dataset.  It runs on the CUDA device unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os.path as osp


def get_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m shgan_torch.generate",
        description="Write an experiment's eval composites as <uid>.png.")
    p.add_argument("--experiment", type=str, required=True)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--pretrained", type=str, default=None)
    p.add_argument("--batch", type=int, default=None,
                   help="engine batch (default: the experiment's)")
    p.add_argument("--n", type=int, default=None,
                   help="only the first N dataset entries")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="serve the blocks above 16² in bfloat16")
    p.add_argument("--debug", action="store_true",
                   help="tiny batch, synthetic data where the data is "
                        "missing, random weights where the weights are")
    p.add_argument("--device", type=str, default=None,
                   help="'cpu' runs the kernels' plain versions; default "
                        "the CUDA device")
    return p.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    from .data.datasets import get_dataset
    from .data.formatters import get_formatter
    from .data.transforms import wrap_formatter
    from .runtime.config import apply_debug_shrink, experiment_cfg_bank
    from .runtime.logging import print_log
    from .serve import InpaintEngine, generate_to_dir

    cfg = experiment_cfg_bank()(args.experiment)
    if args.debug:
        cfg = apply_debug_shrink(cfg)
    cfgv = cfg["eval"]
    seed = args.seed if args.seed is not None else (
        cfg.get("env", {}).get("rnd_seed", 0) or 0)
    if args.n is not None:
        cfgv["dataset"]["try_sample"] = args.n
    batch = (args.batch or cfgv.get("batch_size")
             or cfgv.get("batch_size_per_gpu", 8))
    pretrained = args.pretrained or cfgv.get("pretrained_pth")
    if pretrained and not osp.isfile(pretrained):
        if not args.debug:
            raise FileNotFoundError(pretrained)
        print_log(f"debug: pretrained [{pretrained}] missing: random init")
        pretrained = None

    dataset = get_dataset(cfgv["dataset"], fallback_synthetic=args.debug)
    formatter = wrap_formatter(get_formatter(cfgv["dataset"]["formatter"]),
                               cfgv["dataset"].get("transforms"))
    engine = InpaintEngine(cfg["model_g"], pretrained, batch_size=batch,
                           bf16=args.bf16, seed=seed,
                           strict=cfgv.get("strict_sd", True),
                           device=args.device)
    n = generate_to_dir(engine, dataset, formatter, args.out, log=print_log)
    print_log(f"wrote {n} images to {args.out}")
    return n


if __name__ == "__main__":
    main()
