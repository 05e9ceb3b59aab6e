"""Caption images from the command line with a saved model directory (the
flags of ``python -m mic_tpu.cli.caption``, plus ``--device``): with no
``--device`` the batch is padded to a multiple of the visible cards, as
mic_tpu pads it for its mesh, split over cuda:0..n-1 (one replica of the
serving params a card, the parts generated in turn) and put back together
in order; ``--device cpu`` (or any one device) runs it there.  It prints
one ``path<TAB>caption`` line an image.

    python -m mic_tpu_torch.cli.caption --model_dir runs/cc12m/model \
        --lang en_XX --num_beams 4 img1.jpg img2.jpg
"""

from __future__ import annotations

import argparse
import contextlib
import os

import numpy as np
import torch

from mic_tpu_torch.core.params import make_serving_params, resolve_device, tree_map
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
                        help="torch device (default: every visible CUDA card, the batch "
                             "split over them; 'cpu' for the CPU)")


def load_model(args) -> tuple[Captioner, list, TokenizerBase, list]:
    """The saved model, its params cast once to the compute dtype (as
    generate would cast them on every call) and copied to each device, its
    tokenizer, and the devices (``devices_for``)."""
    devices = devices_for(args.device)
    model, params = Captioner.from_pretrained(args.model_dir, device=devices[0])
    tok_path = args.tokenizer
    if tok_path is None:  # the tokenizer saved with the model, where there is one
        candidate = os.path.join(args.model_dir, "tokenizer.json")
        tok_path = candidate if os.path.exists(candidate) else None
    params = make_serving_params(params, model.dtype)
    replicas = [params] + [tree_map(lambda x, d=d: x.to(d), params) for d in devices[1:]]
    return model, replicas, load_tokenizer(tok_path), devices


def devices_for(device=None) -> list[torch.device]:
    """``device`` alone where given; else every visible card (none raises,
    as ``resolve_device`` does)."""
    if device is not None:
        return [resolve_device(device)]
    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def generate_over_devices(model: Captioner, replicas: list, devices: list, images: np.ndarray,
                          preprocess, **kw) -> np.ndarray:
    """Beam search of uint8 ``images`` (N, H, W, 3) split over ``devices``
    (``replicas[i]`` the params on ``devices[i]``): the batch padded to a
    multiple of the device count with copies of its first image, one equal
    part a device, the parts generated one after another in this thread,
    each with its card as the current device (the kernels launch on the
    current device), the sequences put back in order -> (N, max_length)
    int numpy.  ``preprocess(u8 tensor)`` gives a part's model input on its
    device.  The generate is host-bound: parts in threads of their own
    contend for the interpreter and ran 3-4x slower than one after another
    (PERF.md §6)."""
    n_real = images.shape[0]
    pad = (-n_real) % len(devices)
    if pad:
        images = np.concatenate([images, np.repeat(images[:1], pad, axis=0)])
    outs = []
    for part, params, device in zip(np.split(images, len(devices)), replicas, devices):
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            pixels = preprocess(torch.from_numpy(part).to(device))
            outs.append(model.generate(params, pixels, **kw).sequences)
    return torch.cat([out.cpu() for out in outs]).numpy()[:n_real]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("images", nargs="+")
    parser.add_argument("--lang", default="en_XX")
    add_model_args(parser)
    args = parser.parse_args(argv)

    from mic_tpu_torch.ops.image_prep import preprocess_images

    model, replicas, tokenizer, devices = load_model(args)
    raw = np.stack([load_image(p, 256) for p in args.images])
    seqs = generate_over_devices(
        model, replicas, devices, raw,
        lambda u8: preprocess_images(u8, model.config.vision.image_size, model.dtype),
        max_length=args.max_length, num_beams=args.num_beams,
        decoder_start_token_id=tokenizer.lang_code_to_id[args.lang])
    for path, ids in zip(args.images, seqs):
        print(f"{path}\t{tokenizer.decode(ids)}")


if __name__ == "__main__":
    main()
