"""The sampler suite: the nine entry points of ``pdae_tpu/sampling/samplers.py``
on one card, each a class with ``__init__(config, device=None)`` and
``start()``, dispatched by name through ``SAMPLERS``
(``python -m pdae_torch.sample``).

Each writes the file names and image layouts of its JAX counterpart. The
models run NCHW; dataset items and the images written are NHWC uint8 as
there. Every random number comes through ``BaseSampler.draw``: a
``torch.Generator`` on the sampler's device seeded with (seed, ``SAMPLE``,
salt) (``utils/rng.py``). ``jax.random`` streams cannot be reproduced in
torch, so the port's draws are its own; a test replaces ``draw`` to feed
both packages the same noise. A loop that needs noise at every step gets it
one step at a time (``PerStep``), drawn with salts ``salt0 + step``.

Not ported: LPIPS (``lpips_weights``) and FID (``fid``), which need
pretrained backbones (ROADMAP.md, queue 1 item 13); a config that asks for
either is refused by name.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data import CELEBAHQ_LABEL_TO_ID
from ..metrics import MSEMetric, SSIMMetric
from ..utils import paste_rows, save_checkpoint, save_image_grid, to_uint8
from ..utils.rng import SAMPLE, generator
from .context import SamplerContext


class PerStep:
    """``noise[step]`` drawn when a loop asks for it, so a loop over every
    timestep holds one step's noise at a time; indexed as a ``[T, *shape]``
    tensor would be."""

    def __init__(self, draw, shape, salt0: int, uniform: bool = False):
        self.draw, self.shape, self.salt0, self.uniform = draw, shape, salt0, uniform

    def __getitem__(self, step: int) -> torch.Tensor:
        return self.draw(self.shape, self.salt0 + step, self.uniform)


def _refuse(config: dict, key: str, what: str) -> None:
    if config.get(key):
        raise NotImplementedError(f"{key}: {what} is not ported (it needs pretrained "
                                  "backbone weights; ROADMAP.md, queue 1 item 13)")


def _u8(x: torch.Tensor) -> np.ndarray:
    """NCHW [-1, 1] -> NHWC uint8."""
    return to_uint8(x.permute(0, 2, 3, 1).cpu().numpy())


class BaseSampler:
    def __init__(self, config: dict, device=None):
        self.config = config
        self.ctx = SamplerContext(config, device)
        self.device = self.ctx.device
        self.seed = int(config.get("seed", 0))

    def draw(self, shape, salt: int, uniform: bool = False) -> torch.Tensor:
        """fp32 noise of ``shape`` on the device, N(0, 1), or U[0, 1) when
        ``uniform``, from a generator seeded with (seed, ``SAMPLE``, salt)."""
        gen = generator(self.seed, SAMPLE, salt, self.device)
        sample = torch.rand if uniform else torch.randn
        return sample(tuple(shape), generator=gen, device=self.device)

    def images(self, x_0: np.ndarray) -> torch.Tensor:
        """NHWC float images of a dataset item or batch -> NCHW on the device."""
        return torch.from_numpy(np.ascontiguousarray(x_0)).to(self.device).permute(
            0, 3, 1, 2).contiguous()

    def batches(self, ds, n: int, batch_size: int):
        """``(batch, real)`` over the first ``n`` items in order; the last
        chunk is padded by repeating its last index, so every batch has
        ``batch_size`` images, and ``real`` says how many count."""
        collate = type(ds).collate_fn
        for start in range(0, n, batch_size):
            idxs = list(range(start, min(start + batch_size, n)))
            real = len(idxs)
            idxs += [idxs[-1]] * (batch_size - real)
            yield collate([ds[i] for i in idxs]), real

    def start(self):
        raise NotImplementedError


class TestDPMs(BaseSampler):
    """Sanity check of a pre-trained DPM: ``ddim_style`` (ddim100) from
    noise, a grid of ``num_samples`` (9)."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ch, size = int(self.config["image_channel"]), int(self.config["image_size"])
        n = int(self.config.get("num_samples", 9))
        ctx.build_denoise()
        style = self.config.get("ddim_style", "ddim100")
        x_T = self.draw((n, ch, size, size), 0)
        samples = _u8(ctx.gd.test_pretrained_dpms(style, ctx.denoise_fn, x_T))
        out = ctx.output_path("test_dpms_result.png")
        save_image_grid(samples, out, nrow=int(math.ceil(math.sqrt(n))))
        return out


class AutoencodingExample(BaseSampler):
    """One image: its deterministic autoencode (``encoder_ddim_style``
    ddim1000, ``decoder_ddim_style`` ddim100), then 5 DDIM and 5 ancestral
    DDPM decodes of its latent from random x_T, in one row. Draws: the DDIM
    row's x_T (salt 0), the DDPM row's x_T (1) and its per-step noise
    (2 + step)."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        data = ctx.dataset()[int(self.config["image_index"])]
        x_0 = self.images(data["x_0"][None])
        gd, enc, dec = ctx.gd, ctx.encoder, ctx.decoder
        enc_style = self.config.get("encoder_ddim_style", "ddim1000")
        dec_style = self.config.get("decoder_ddim_style", "ddim100")

        recon = gd.representation_learning_autoencoding(enc_style, dec_style, enc, dec, x_0)
        x_0_rep = x_0.repeat(5, 1, 1, 1)
        shape = tuple(x_0_rep.shape)
        ddpm = gd.representation_learning_ddpm_sample(
            None, enc, dec, x_0_rep, self.draw(shape, 1), noise=PerStep(self.draw, shape, 2))
        ddim = gd.representation_learning_ddim_sample(dec_style, enc, dec, x_0_rep,
                                                      self.draw(shape, 0))
        row = np.concatenate([data["gt"][None], _u8(recon), _u8(ddim), _u8(ddpm)])
        out = ctx.output_path("autoencoding_example_result.png")
        save_image_grid(row, out, nrow=row.shape[0])
        return out


class AutoencodingEval(BaseSampler):
    """Reconstruction metrics over the dataset (or its first
    ``max_samples``): autoencode each batch of ``batch_size`` (16) at
    ``encoder_ddim_style``/``decoder_ddim_style`` (ddim1000/ddim100), then
    SSIM and MSE of the pairs on [0, 1]. Returns ``{"ssim", "mse"}``."""

    @torch.inference_mode()
    def start(self):
        _refuse(self.config, "lpips_weights", "LPIPS")
        ctx = self.ctx
        ctx.build_pdae()
        ds = ctx.dataset()
        enc_style = self.config.get("encoder_ddim_style", "ddim1000")
        dec_style = self.config.get("decoder_ddim_style", "ddim100")
        max_samples = self.config.get("max_samples")
        n = len(ds) if max_samples is None else min(int(max_samples), len(ds))
        ssim_m, mse_m = SSIMMetric(), MSEMetric()
        for batch, real in self.batches(ds, n, int(self.config.get("batch_size", 16))):
            x_0 = self.images(batch["x_0"])
            recon = ctx.gd.representation_learning_autoencoding(
                enc_style, dec_style, ctx.encoder, ctx.decoder, x_0)[:real]
            a = (recon + 1.0) / 2.0
            b = (x_0[:real] + 1.0) / 2.0
            ssim_m.process(a, b)
            mse_m.process(a.cpu().numpy(), b.cpu().numpy())
        for m in (ssim_m, mse_m):
            m.all_gather_results()
        results = {"ssim": ssim_m.compute_metrics(), "mse": mse_m.compute_metrics()}
        print({k: f"{v:.6g}" for k, v in results.items()})
        return results


class InferLatents(BaseSampler):
    """Encode the dataset (or its first ``max_samples``) in batches of
    ``batch_size`` (100) and write ``{mean, std}`` of the latents (std with
    ddof 1) to ``output_path`` (``./<dataset name>.ckpt``), a file both
    packages read."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        ds = ctx.dataset()
        max_samples = self.config.get("max_samples")
        n = len(ds) if max_samples is None else min(int(max_samples), len(ds))
        zs = [ctx.encoder(self.images(batch["x_0"]))[:real].cpu().numpy()
              for batch, real in self.batches(ds, n, int(self.config.get("batch_size", 100)))]
        latent = np.concatenate(zs, axis=0)
        ds_cfg = self.config["dataset_config"]
        name = ds_cfg.get("name", ds_cfg.get("dataset_name"))
        out = self.config.get("output_path", f"./{str(name).lower()}.ckpt")
        save_checkpoint(out, {"mean": latent.mean(0), "std": latent.std(0, ddof=1)})
        return out


class GapMeasure(BaseSampler):
    """Posterior-mean-gap curves over every t, without and with the shift,
    averaged over full batches of ``batch_size`` (16) covering
    ``num_samples`` (1000) images; a curve PNG, or ``<out>.npz`` where
    matplotlib is not installed. The noise is uniform in [0, 1), the
    reference's quirk; batch ``start`` draws step ``s`` with salt
    ``start * timesteps + s``. Returns the two curves (t = T-1 .. 0)."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        ds = ctx.dataset()
        gd = ctx.gd
        batch_size = int(self.config.get("batch_size", 16))
        total_eff = min(int(self.config.get("num_samples", 1000)), len(ds))
        # the gaps are means over the batch: only full batches count
        n_full = max((total_eff // batch_size) * batch_size, batch_size)
        if n_full != total_eff:
            print(f"gap_measure: using {n_full} samples (full batches of {batch_size}; "
                  f"{total_eff} requested)")
        collate = type(ds).collate_fn
        gaps, ae_gaps = [], []
        for start in range(0, n_full, batch_size):
            batch = collate([ds[i % len(ds)] for i in range(start, start + batch_size)])
            x_0 = self.images(batch["x_0"])
            noise = PerStep(self.draw, tuple(x_0.shape), start * gd.timesteps, uniform=True)
            g, ag = gd.representation_learning_gap_measure(None, ctx.encoder, ctx.decoder,
                                                           x_0, noise=noise)
            gaps.append(g.cpu().numpy())
            ae_gaps.append(ag.cpu().numpy())
        gap = np.mean(np.stack(gaps), axis=0)
        ae_gap = np.mean(np.stack(ae_gaps), axis=0)

        out = ctx.output_path("gap_measure_result.png")
        try:
            import matplotlib
        except ImportError:
            np.savez(out + ".npz", gap=gap, ae_gap=ae_gap)
            return gap, ae_gap
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        ts = np.arange(gd.timesteps - 1, -1, -1)
        plt.figure(figsize=(8, 5))
        plt.plot(ts, gap, label="pre-trained DPM")
        plt.plot(ts, ae_gap, label="PDAE (with shift)")
        plt.xlabel("timestep")
        plt.ylabel("posterior mean gap (MSE)")
        plt.legend()
        plt.savefig(out, dpi=120)
        plt.close()
        return gap, ae_gap


class DenoiseOneStep(BaseSampler):
    """One image at each t of ``timestep_list``: the x_0 predicted in one
    step without and with the shift, two rows after the image (noise:
    salt 0)."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        data = ctx.dataset()[int(self.config["image_index"])]
        timestep_list = list(self.config.get("timestep_list", [400, 500, 600, 700, 800]))
        x_0 = self.images(data["x_0"][None]).repeat(len(timestep_list), 1, 1, 1)
        pred_x0, ae_pred_x0 = ctx.gd.representation_learning_denoise_one_step(
            None, ctx.encoder, ctx.decoder, x_0, timestep_list,
            noise=self.draw(tuple(x_0.shape), 0))
        gt = data["gt"][None]
        out = ctx.output_path("denoise_one_step_result.png")
        paste_rows([np.concatenate([gt, _u8(pred_x0)]),
                    np.concatenate([gt, _u8(ae_pred_x0)])], out)
        return out


class Interpolation(BaseSampler):
    """Two images at each of ``alphas``: row 1 decodes slerp(x_T) with
    lerp(z); row 2 runs the trajectory interpolation, the gradient blended
    at every step (``ddim_style``, ddim100)."""

    @staticmethod
    def slerp(a, b, alpha):
        af, bf = a.reshape(-1), b.reshape(-1)
        theta = torch.arccos(torch.dot(af, bf) / (torch.linalg.vector_norm(af)
                                                  * torch.linalg.vector_norm(bf)))
        sin_theta = torch.sin(theta)
        return (a * torch.sin((1.0 - alpha) * theta) / sin_theta
                + b * torch.sin(alpha * theta) / sin_theta)

    @staticmethod
    def lerp(a, b, alpha):
        return (1.0 - alpha) * a + alpha * b

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        ds = ctx.dataset()
        d1 = ds[int(self.config["image_index_1"])]
        d2 = ds[int(self.config["image_index_2"])]
        x_0 = self.images(np.stack([d1["x_0"], d2["x_0"]]))
        gd, dec = ctx.gd, ctx.decoder
        style = self.config.get("ddim_style", "ddim100")

        z = ctx.encoder(x_0)
        x_T = gd.representation_learning_ddim_encode(style, ctx.encoder, dec, x_0, z)
        z_1, z_2 = z[0:1], z[1:2]
        x_T_1, x_T_2 = x_T[0:1], x_T[1:2]
        alphas = list(self.config.get(
            "alphas", [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]))
        row1, row2 = [d1["gt"]], [d1["gt"]]
        for a in alphas:
            xt = self.slerp(x_T_1, x_T_2, a)
            img1 = gd.representation_learning_ddim_sample(style, None, dec, None, xt,
                                                          self.lerp(z_1, z_2, a))
            img2 = gd.representation_learning_ddim_trajectory_interpolation(
                style, dec, z_1, z_2, xt, a)
            row1.append(_u8(img1)[0])
            row2.append(_u8(img2)[0])
        row1.append(d2["gt"])
        row2.append(d2["gt"])
        out = ctx.output_path("interpolation_result.png")
        paste_rows([np.stack(row1), np.stack(row2)], out)
        return out


class Manipulation(BaseSampler):
    """One image: infer its x_T (``encode_ddim_style``, ddim500), move its
    latent along the classifier's unit row for ``attribute`` (a CelebA-HQ
    name), else ``class_id`` (31, Smiling), by each of ``scale_list``, and
    decode (``decode_ddim_style``, ddim200); one row, the image in the
    middle."""

    @torch.inference_mode()
    def start(self):
        ctx = self.ctx
        ctx.build_pdae()
        data = ctx.dataset()[int(self.config["image_index"])]
        x_0 = self.images(data["x_0"][None])
        gd, enc, dec = ctx.gd, ctx.encoder, ctx.decoder
        mean, std = ctx.latent_stats()
        weight = ctx.classifier_weight()
        if "attribute" in self.config:
            attribute = self.config["attribute"]
            if attribute not in CELEBAHQ_LABEL_TO_ID:
                raise ValueError(f"unknown attribute {attribute!r}; one of "
                                 f"{sorted(CELEBAHQ_LABEL_TO_ID)}")
            class_id = CELEBAHQ_LABEL_TO_ID[attribute]
        else:
            class_id = int(self.config.get("class_id", 31))
        scale_list = list(self.config.get("scale_list", [-0.3, -0.1, 0.1, 0.3]))
        enc_style = self.config.get("encode_ddim_style", "ddim500")
        dec_style = self.config.get("decode_ddim_style", "ddim200")

        x_T = gd.representation_learning_ddim_encode(enc_style, enc, dec, x_0)
        results = [_u8(gd.manipulation_sample(dec_style, weight, enc, dec, x_0, x_T, mean,
                                              std, class_id, float(s)))[0]
                   for s in scale_list]
        half = len(scale_list) // 2
        row = results[:half] + [data["gt"]] + results[half:]
        out = ctx.output_path("manipulation_result.png")
        save_image_grid(np.stack(row), out, nrow=len(row))
        return out


class UnconditionalSample(BaseSampler):
    """``num_samples`` (16) images through the latent DPM in batches of
    ``batch_size``: z_T ~ N(0, 1) clamped, the latent loop
    (``latent_ddim_style``), denormalized, then the shift decode of x_T with
    stop_percent 0.3 (``decoder_ddim_style``); one grid. The batch after
    ``done`` images draws x_T with salt ``2 * done`` and z_T with
    ``2 * done + 1``."""

    @torch.inference_mode()
    def start(self):
        _refuse(self.config, "fid", "FID")
        ctx = self.ctx
        ctx.build_pdae()
        latent_denoise_fn = ctx.build_latent()
        ds_cfg = self.config.get("dataset_config") or {}
        ch = int(self.config.get("image_channel", ds_cfg.get("image_channel", 3)))
        size = int(self.config.get("image_size", ds_cfg.get("image_size")))
        n = int(self.config.get("num_samples", 16))
        batch = int(self.config.get("batch_size", min(n, 64)))
        mean, std = ctx.latent_stats()
        lat_style = self.config.get("latent_ddim_style", "ddim100")
        dec_style = self.config.get("decoder_ddim_style", "ddim100")
        latent_dim = ctx.latent_input_channel

        imgs, done = [], 0
        while done < n:
            b = min(batch, n - done)
            # a constant batch shape: the last batch is drawn whole and trimmed
            x_T = self.draw((batch, ch, size, size), 2 * done)
            z_T = self.draw((batch, latent_dim), 2 * done + 1)
            out = ctx.gd.latent_diffusion_sample(
                None, lat_style, dec_style, latent_denoise_fn, ctx.decoder, x_T, mean, std,
                latent_dim=latent_dim, z_T=z_T)
            imgs.append(_u8(out[:b]))
            done += b
        out = ctx.output_path("unconditional_sample_result.png")
        if imgs:
            save_image_grid(np.concatenate(imgs), out)
        return out


SAMPLERS = {
    "test_dpms": TestDPMs,
    "autoencoding_example": AutoencodingExample,
    "autoencoding_eval": AutoencodingEval,
    "infer_latents": InferLatents,
    "gap_measure": GapMeasure,
    "denoise_one_step": DenoiseOneStep,
    "interpolation": Interpolation,
    "manipulation": Manipulation,
    "unconditional_sample": UnconditionalSample,
}
