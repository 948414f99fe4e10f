"""The port's public import surface: the names ``shgan_tpu`` re-exports from
its packages resolve in ``shgan_torch``, and a module type registered with
``@register`` builds through ``get_model``.

The names are listed as text (from ``shgan_tpu/__init__.py:22-28`` and the
``__init__.py`` of ``shgan_tpu/data``, ``models``, ``ops`` and
``parallel``), so this file imports nothing of JAX.  Left out by design:
the JAX-side formulations the port has no use for (``ops.dense_init``, a
functional initializer; ``ops.set_noise_impl``, the TPU noise switch;
``parallel``'s ``replicated`` / ``batch_sharding`` / ``shard_batch`` /
``local_batch_to_global``, named shardings of a ``jax.Array``).
"""

import importlib
import subprocess
import sys

import pytest
import torch.nn as nn

from test_torch_models import REPO

JAX_NAMES = {
    "shgan_torch": "get_model get_dataset get_evaluator InpaintEngine "
                   "generate_to_dir",
    "shgan_torch.data": "random_mask random_brush MixedMaskGenerator "
                        "LAMA_SETTINGS make_random_irregular_mask "
                        "make_random_rectangle_mask "
                        "make_random_superres_mask FFHQZipDataset "
                        "Places2Dataset ImageDirDataset SyntheticDataset "
                        "get_dataset RandomMaskFormatter LamaMaskFormatter "
                        "CenterMaskFormatter NoMaskFormatter shard_indices "
                        "DataShard EvalPipeline TrainPipeline",
    "shgan_torch.models": "Dense Conv2d Conv2dLayer SynthesisLayer "
                          "ToRGBLayer normalize_2nd_moment Mapping "
                          "StyleGANSynthesisBlock StyleGANSynthesis "
                          "CoModSynthesisBlockFirst CoModSynthesisBlock "
                          "CoModSynthesis CoModSynthesisPlur EncoderBlock "
                          "EncoderEpilogue Encoder DiscrimBlock "
                          "DiscrimEpilogue Discriminator SHU ShganEncoder "
                          "StyleGANGenerator CoModGANGenerator get_model "
                          "register MODEL_REGISTRY",
    "shgan_torch.ops": "setup_filter upfirdn2d filter2d upsample2d "
                       "downsample2d conv2d_resample modulated_conv2d "
                       "lrelu_agc get_activation dense_apply minibatch_std "
                       "fma random_noise",
    "shgan_torch.parallel": "create_mesh check_replicated "
                            "maybe_initialize_distributed is_lead "
                            "local_rows allgather_rows spatial_sharding "
                            "constrain",
    "shgan_torch.eval": "get_evaluator register_evaluator",
}


@pytest.mark.parametrize("package", sorted(JAX_NAMES))
def test_jax_reexports_resolve_in_the_port(package):
    mod = importlib.import_module(package)
    missing = [n for n in JAX_NAMES[package].split()
               if getattr(mod, n, None) is None]
    assert not missing, (package, missing)
    with pytest.raises(AttributeError):
        getattr(mod, "no_such_name")


def test_register_adds_a_type_that_get_model_builds():
    import shgan_torch
    from shgan_torch.models import MODEL_REGISTRY, register

    @register("test_torch_package_block")
    class Block(nn.Module):
        def __init__(self, width, generator=None):
            super().__init__()
            self.width = width
            self.generator = generator

    try:
        m = shgan_torch.get_model({"type": "test_torch_package_block",
                                   "args": {"width": 7}}, seed=3)
        assert isinstance(m, Block) and m.width == 7
        assert m.generator is not None
    finally:
        MODEL_REGISTRY.pop("test_torch_package_block")


def test_public_names_leave_jax_out():
    code = ("import sys, shgan_torch, shgan_torch.parallel.spatial\n"
            "for n in shgan_torch.__all__: getattr(shgan_torch, n)\n"
            "import shgan_torch.data as d\n"
            "for n in d.__all__: getattr(d, n)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(("
            "'jax.', 'shgan_tpu'))]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
