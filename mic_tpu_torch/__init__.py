"""mic_tpu_torch: the PyTorch + CUDA port of mic_tpu for NVIDIA Hopper."""
