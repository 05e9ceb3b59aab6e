"""Caption images from the command line with a saved model directory (the
flags of ``python -m mic_tpu.cli.caption``, plus ``--device``): one
generate over the batch on one device, the CUDA card unless ``--device
cpu``.  It prints one ``path<TAB>caption`` line an image.

    python -m mic_tpu_torch.cli.caption --model_dir runs/cc12m/model \
        --lang en_XX --num_beams 4 img1.jpg img2.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mic_tpu_torch.core.params import make_serving_params, resolve_device
from mic_tpu_torch.data.images import load_image
from mic_tpu_torch.data.tokenizer import TokenizerBase, load_tokenizer
from mic_tpu_torch.models.captioner import Captioner


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The flags both CLIs share: the model directory, the tokenizer, the
    generate lengths and the device."""
    parser.add_argument("--model_dir", required=True)
    parser.add_argument("--tokenizer", default=None,
                        help="HF tokenizer dir or SimpleTokenizer json (default: the "
                             "tokenizer.json saved with the model, if any)")
    parser.add_argument("--num_beams", type=int, default=4)
    parser.add_argument("--max_length", type=int, default=64)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' for the CPU)")


def load_model(args) -> tuple[Captioner, dict, TokenizerBase, torch.device]:
    """The saved model with its params cast once to the compute dtype (as
    generate would cast them on every call), its tokenizer, its device."""
    device = resolve_device(args.device)
    model, params = Captioner.from_pretrained(args.model_dir, device=device)
    tok_path = args.tokenizer
    if tok_path is None:  # the tokenizer saved with the model, where there is one
        candidate = os.path.join(args.model_dir, "tokenizer.json")
        tok_path = candidate if os.path.exists(candidate) else None
    return model, make_serving_params(params, model.dtype), load_tokenizer(tok_path), device


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("images", nargs="+")
    parser.add_argument("--lang", default="en_XX")
    add_model_args(parser)
    args = parser.parse_args(argv)

    from mic_tpu_torch.ops.image_prep import preprocess_images

    model, params, tokenizer, device = load_model(args)
    raw = np.stack([load_image(p, 256) for p in args.images])
    pixels = preprocess_images(torch.from_numpy(raw).to(device), model.config.vision.image_size,
                               model.dtype)
    out = model.generate(params, pixels, max_length=args.max_length, num_beams=args.num_beams,
                         decoder_start_token_id=tokenizer.lang_code_to_id[args.lang])
    for path, ids in zip(args.images, out.sequences.cpu().numpy()):
        print(f"{path}\t{tokenizer.decode(ids)}")


if __name__ == "__main__":
    main()
