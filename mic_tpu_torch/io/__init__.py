from mic_tpu_torch.io.checkpoint import load_params, save_params  # noqa: F401
