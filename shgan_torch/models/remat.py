"""Per-block rematerialization (the JAX package's ``remat``: each block
under ``jax.checkpoint``, ``shgan_tpu/models/encoder.py:180-182``): a block
keeps only its inputs for the backward and runs its forward again when the
backward first needs its activations, one more forward of the block for
activation memory that no longer grows with the depth.

The block runs under ``torch.utils.checkpoint`` (non-reentrant, so
``torch.autograd.grad(create_graph=True)`` of R1 and the path-length
penalty differentiates through it).  A differentiated backward, such as the
penalties' first ``grad``, reaches the original forward's nodes again, so
its own backward recomputes the blocks it passes once more.

What makes the recompute equal the first forward, bit for bit:

* the random noise is drawn from integer seeds through Philox counters
  (the epilogue kernel, ``csrc/philox.cuh``), never from a
  ``torch.Generator`` or the global RNG, so the RNG state is not stashed
  (``preserve_rng_state=False``; ``tests/test_torch_remat.py`` holds the
  global RNG still over a block);
* a block casts to its own dtype inside, so a bf16 block rounds as it did;
* the in-place epilogue runs only where nothing needs a gradient, which a
  checkpointed block (grad mode on) never is;
* the spatial-sharding state is the caller's: the recompute may run on the
  autograd engine's device thread, so the block runs under the state it
  was called with (:func:`~shgan_torch.parallel.spatial.within`), and every
  rank replays its halo exchanges and sums in the order of its backward,
  which is the same on every rank.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..parallel import spatial


def remat_call(on, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, checkpointed when ``on`` and grad mode is on
    (without a gradient there is nothing to keep: a plain call)."""
    if not (on and torch.is_grad_enabled()):
        return fn(*args, **kwargs)
    cfg = spatial.state()

    def run(*a, **k):
        with spatial.within(cfg):
            return fn(*a, **k)
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False, **kwargs)
