"""What the reference, the weights and the counts read of a configuration.

Every file under ``configs/`` has one schema, the sections of its source's
representation-learning config (``train_dataset_config``,
``encoder_config``, ``denoise_fn_config``, ``optimizer_config``,
``runner_config``, ...), so any traffic kind can run any configuration.
"""

from __future__ import annotations


def geometry(config: dict) -> dict:
    """The sizes, precision and optimizer of ``config``: the image size and
    corpus length from ``train_dataset_config``, the compute dtype from
    ``optimizer_config.enable_amp`` (bf16 over fp32 parameters, else fp32)."""
    data, opt = config["train_dataset_config"], config["optimizer_config"]
    return {"image_size": int(data["image_size"]),
            "dataset_length": int(data["length"]),
            "latent_dim": int(config["encoder_config"]["latent_dim"]),
            "dpm": {k: v for k, v in config["denoise_fn_config"].items() if k != "model"},
            "compute_dtype": "bfloat16" if opt.get("enable_amp") else "float32",
            "diffusion": config["diffusion_config"],
            "optimizer": {**opt, "adam_betas": tuple(float(b) for b in opt["adam_betas"])},
            "ema_decay": float(config["runner_config"]["ema_decay"])}
