"""What the drivers hand the port: its command-line flags for a
configuration's sizes, and the device line of a result."""

import torch


def dim_flags(config):
    """Every size and training setting of ``config`` as the port's flags
    (family, widths, depths, dropout rates, the MMD terms, batch, Adam, the
    clip, the loss weights and beta's schedule), so the program runs the
    configuration's file whatever its defaults."""
    f = ["--max_seq_len", config["max_seq_len"],
         "--model.z_dim", config["z_dim"], "--model.c_dim", config["c_dim"],
         "--model.emb_dim", config["emb_dim"]]
    if config["family"] == "gru":
        f += ["--model.E_args.E_class", "gru", "--model.G_args.G_class", "gru",
              "--model.E_args.h_dim", config["enc_h_dim"],
              "--model.G_args.GRU_args.p_word_dropout", config["p_word_dropout"],
              "--model.G_args.GRU_args.p_out_dropout", config["p_out_dropout"]]
    else:
        f += ["--model.E_args.E_class", "transformer",
              "--model.G_args.G_class", "transformer",
              "--model.G_args.T_args.p_word_dropout", config["p_word_dropout"]]
        for leg in ("E_args", "G_args"):
            for k in ("d_model", "n_layers", "d_ff", "n_heads", "p_dropout"):
                f += [f"--model.{leg}.T_args.{k}", config[k]]
    f += ["--losses.wae_mmd.rf_dim", config["rf_dim"],
          "--losses.wae_mmd.sigma", config["sigma"],
          "--vae.batch_size", config["batch_size"], "--vae.lr", config["lr"],
          "--shared.clip_grad", config["clip_grad"],
          "--vae.lambda_logvar_L1", config["lambda_logvar_L1"],
          "--vae.lambda_logvar_KL", config["lambda_logvar_KL"]]
    (v0, i0), (v1, i1) = config["beta"]
    f += ["--vae.beta.start.val", v0, "--vae.beta.start.iter", i0,
          "--vae.beta.end.val", v1, "--vae.beta.end.iter", i1]
    return [str(x) for x in f]


def device_info(device, memory_peak):
    """The result line's ``device``: the card's name, the cards used and the
    peak of allocated device memory."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(memory_peak)}
