"""BLEU-1..4 per language of a saved model over a caption TSV (the flags of
``python -m mic_tpu.cli.evaluate``, plus ``--device``): beam-search
captions of each language's rows, batch by batch, scored against the TSV's
captions.  With no ``--device`` the batch size is rounded up to a multiple
of the visible cards, as mic_tpu rounds it to its mesh, and every batch is
split over them (cli/caption.py::generate_over_devices); ``--device cpu``
(or any one device) runs it there.

    python -m mic_tpu_torch.cli.evaluate --model_dir runs/cc12m/model \
        --tsv_path data/val.tsv --images_dir images/ --batch_size 64 --num_beams 4
"""

from __future__ import annotations

import argparse
import json

from mic_tpu_torch.cli.caption import add_model_args, generate_over_devices, load_model


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tsv_path", required=True)
    parser.add_argument("--images_dir", default="")
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--decode_size", type=int, default=256)
    parser.add_argument("--output_json", default=None)
    parser.add_argument(
        "--start_convention", default="pad", choices=["pad", "eos", "lang"],
        help="decoder start for generation: 'pad' (training-consistent: PAD start + language "
             "forced at position 1, best BLEU), 'eos' (reference evaluation.py: EOS start + "
             "forced language BOS), 'lang' (reference main.py eval: language code as start "
             "token)",
    )
    add_model_args(parser)
    args = parser.parse_args(argv)

    from mic_tpu_torch.data.dataset import CaptionDataset
    from mic_tpu_torch.data.loader import CaptionLoader
    from mic_tpu_torch.evals.bleu import bleu_1_to_4
    from mic_tpu_torch.ops.image_prep import maybe_preprocess

    model, replicas, tokenizer, devices = load_model(args)
    dataset = CaptionDataset(args.tsv_path, args.images_dir)
    dec = model.config.decoder
    batch_size = -(-args.batch_size // len(devices)) * len(devices)

    results = {}
    for lang, sub in dataset.split_by_language().items():
        loader = CaptionLoader(sub, tokenizer, batch_size, image_size=args.decode_size,
                               max_length=args.max_length, shuffle=False, drop_last=False)
        start = tokenizer.lang_code_to_id[lang]
        kw = {"pad": dict(decoder_start_token_id=dec.pad_token_id, forced_bos_token_id=start),
              "eos": dict(decoder_start_token_id=dec.eos_token_id, forced_bos_token_id=start),
              "lang": dict(decoder_start_token_id=start)}[args.start_convention]
        preds, refs = [], []
        try:
            for batch in loader.epoch_iterator(epoch=0):
                seqs = generate_over_devices(
                    model, replicas, devices, batch["pixel_values"],
                    lambda u8: maybe_preprocess(u8, model.config.vision.image_size, model.dtype),
                    max_length=args.max_length, num_beams=args.num_beams, **kw)
                preds.extend(tokenizer.batch_decode(seqs))
                refs.extend(tokenizer.batch_decode(batch["labels"]))
        finally:
            loader.close()
        results[lang] = bleu_1_to_4(preds, refs, lang[:2])
        print(lang, results[lang])

    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
