"""Perceptual path length, with the generator in the loop (port of
``shgan_tpu/eval/ppl.py``).

PPL moves the latent by ε along a random interpolation and measures the
LPIPS distance of the two rendered images over ε², with a 1 %/99 % tail
filter.  The generator is conditional: each sample renders against a
(mask ‖ masked image) context kept from the eval stream, and the encoder
runs once for both images of a sample.

Both synthesis calls of a sample take one ``noise_seed``, so the two images
share their noise and differ only by the latent step (the port's noise is
keyed by seed, layer and row: one forward over the concatenated pair would
give rows i and N+i different noise, which ε² = 1e-8 would blow up).  z, t
and the noise seeds come from a ``torch.Generator`` seeded from ``seed``
(the JAX package draws them with ``jax.random``, so the two packages'
samples differ).

The LPIPS embedding defaults to ``net='vgg16'``, the reference's backbone;
without the vgg16 weights it falls back to ``net='alex'`` and says so in
the log.  ``max_contexts`` bounds the pool of contexts; a run with
``num_samples > max_contexts`` reuses them (``idx % len(contexts)``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.multihost import world_size
from .base import BaseEvaluator, register_evaluator
from .lpips import lpips_distance, lpips_params_to, resolve_lpips_params
from .stylegan_metrics import ppl_from_distances


def slerp(a, b, t):
    """Spherical interpolation of the rows of ``a`` and ``b`` (tensors)."""
    a = a / a.norm(dim=-1, keepdim=True)
    b = b / b.norm(dim=-1, keepdim=True)
    d = (a * b).sum(dim=-1, keepdim=True)
    p = t * torch.arccos(d.clamp(-1.0, 1.0))
    c = b - d * a
    c = c / c.norm(dim=-1, keepdim=True)
    out = a * torch.cos(p) + c * torch.sin(p)
    return out / out.norm(dim=-1, keepdim=True)


def make_ppl_sampler(G, lpips_params, epsilon=1e-4, space="w",
                     sampling="end", crop=False, net="alex"):
    """→ ``sample(x, z0, z1, t, noise_seed)`` → [N] PPL distances, under
    ``torch.inference_mode`` on the device of ``x``; ``sample.distance``
    gives the same pairs' LPIPS before the division by ε².
    ``lpips_params`` must lie on that device
    (:func:`~.lpips.lpips_params_to`)."""
    if space not in ("z", "w") or sampling not in ("full", "end"):
        raise ValueError(f"space {space!r}, sampling {sampling!r}")

    def distance(x, z0, z1, t, noise_seed):
        with torch.inference_mode():
            if space == "w":
                ws0, ws1 = G.mapping(z0), G.mapping(z1)
                tt = t[:, None, None]
                wt0 = ws0 + (ws1 - ws0) * tt
                wt1 = ws0 + (ws1 - ws0) * (tt + epsilon)
            else:
                wt0 = G.mapping(slerp(z0, z1, t[:, None]))
                wt1 = G.mapping(slerp(z0, z1, t[:, None] + epsilon))
            x_global, feats = G.encoder(x)
            img0 = G.synthesis(x_global, feats, wt0, noise_mode="random",
                               noise_seed=noise_seed)
            img1 = G.synthesis(x_global, feats, wt1, noise_mode="random",
                               noise_seed=noise_seed)
            img = torch.cat([img0, img1], dim=0)
            if crop:   # the reference's center crop
                c = img.shape[2] // 8
                img = img[:, :, c * 3:c * 7, c * 2:c * 6]
            factor = img.shape[2] // 256
            if factor > 1:   # box-downsample to 256
                n, ch, h, w = img.shape
                img = img.reshape(n, ch, h // factor, factor, w // factor,
                                  factor).mean(dim=(3, 5))
            d0, d1 = img.chunk(2, dim=0)
            return lpips_distance(lpips_params, d0, d1, net=net)

    def sample(x, z0, z1, t, noise_seed):
        return distance(x, z0, z1, t, noise_seed) / (epsilon ** 2)

    sample.distance = distance
    return sample


@register_evaluator("ppl")
class PPLEvaluator(BaseEvaluator):
    """The reference's variants by ``space`` ('w' | 'z'), ``sampling``
    ('end' | 'full') and ``crop``; ppl2_wend is space='w',
    sampling='end', crop=False."""

    needs_generator = True
    consumes_host_pixels = False
    consumes_device_views = True

    def __init__(self, num_samples=2000, epsilon=1e-4, space="w",
                 sampling="end", crop=False, batch_size=8, net="vgg16",
                 alexnet_weights=None, vgg16_weights=None, lin_weights=None,
                 lpips_params=None, max_contexts=256, **_):
        super().__init__()
        self.num_samples = num_samples
        self.epsilon = epsilon
        self.space = space
        self.sampling = sampling
        self.crop = crop
        self.batch_size = batch_size
        self.net = net
        self.max_contexts = max_contexts
        if lpips_params is not None:
            self.lpips_params = lpips_params
        else:
            try:
                self.lpips_params = resolve_lpips_params(
                    net, alexnet_weights=alexnet_weights,
                    vgg16_weights=vgg16_weights, lin_weights=lin_weights)
            except FileNotFoundError as e:
                if net != "vgg16":
                    raise
                # a setup with only the LPIPS metric's alex weights still
                # runs, and says that its PPL is not the reference's
                try:
                    self.lpips_params = resolve_lpips_params(
                        "alex", alexnet_weights=alexnet_weights,
                        lin_weights=lin_weights)
                except FileNotFoundError:
                    raise e from None
                self.net = "alex"
                self._log(
                    "PPL: vgg16 LPIPS weights not found — falling back to "
                    "net=alex (absolute PPL not comparable to the "
                    "reference's vgg16 embedding; set SHGAN_TPU_VGG16 + "
                    "SHGAN_TPU_LPIPS_LIN_VGG for protocol-exact runs)")
        self._contexts = []   # [C, H, W] generator inputs (mask ‖ masked)
        self.data_dist = []

    def add_batch(self, real=None, mask=None, valid=None, real_dev=None,
                  **_):
        """Keep conditional contexts from the eval stream: ``real_dev`` (or
        ``real``) holds the reals as 0..255 values, ``mask`` the {0, 1}
        hole mask [N, 1, H, W]; the contexts stay where they lie."""
        if mask is None or len(self._contexts) >= self.max_contexts:
            return
        r = torch.as_tensor(real if real_dev is None else real_dev)
        r = r.float() / 127.5 - 1.0
        m = torch.as_tensor(mask).to(r.device).float()
        x = torch.cat([m - 0.5, r * m], dim=1)
        (x,) = self._apply_valid([x], valid)
        take = self.max_contexts - len(self._contexts)
        self._contexts.extend(x[:take].unbind(0))

    def run_generator_metrics(self, G, seed=0):
        """The sampling loop: ``num_samples`` distances in batches of
        ``batch_size`` on the contexts' device.  One process only, as in
        the JAX package: each rank's contexts are its own rows."""
        if world_size() > 1:
            raise NotImplementedError(
                "PPL runs in one process: the conditioning contexts are "
                "each rank's own rows; run the ppl evaluator in a "
                "one-process eval")
        if not self._contexts:
            raise RuntimeError(
                "PPL has no conditional contexts: add_batch with mask= must "
                "run before run_generator_metrics")
        ctx = torch.stack(self._contexts)
        dev = ctx.device
        sampler = make_ppl_sampler(
            G, lpips_params_to(self.lpips_params, dev), self.epsilon,
            self.space, self.sampling, self.crop, net=self.net)
        gen = torch.Generator().manual_seed(int(seed))
        bs = self.batch_size
        for start in range(0, self.num_samples, bs):
            idx = torch.arange(start, start + bs) % len(ctx)
            z = torch.randn(2 * bs, G.z_dim, generator=gen)
            t = (torch.rand(bs, generator=gen) if self.sampling == "full"
                 else torch.zeros(bs))
            noise_seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                           generator=gen))
            self.data_dist.append(sampler(
                ctx[idx.to(dev)], z[:bs].to(dev), z[bs:].to(dev), t.to(dev),
                noise_seed))

    def compute(self):
        if not self.data_dist:
            self.final["ppl"] = float("nan")
            return self.final["ppl"]
        dist = np.concatenate([d.double().cpu().numpy()
                               for d in self.data_dist])[:self.num_samples]
        self.final["ppl"] = ppl_from_distances(dist)
        return self.final["ppl"]

    def one_line_summary(self):
        self._log("Evaluator ppl: {:.4f}".format(self.final["ppl"]))

    def clear_data(self):
        self._contexts = []
        self.data_dist = []
