"""Push a saved model directory to the Hugging Face Hub, an explicit step
after training, so that a training run never waits on the network:

  python -m mic_tpu_torch.cli.push --model_dir runs/cc12m/model \
      --repo_id me/clip-vit-mbart50-captioner [--private]
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--repo_id", required=True)
    ap.add_argument("--private", action="store_true")
    ap.add_argument("--commit_message", default="Upload mic_tpu model")
    ap.add_argument("--token", default=None)
    args = ap.parse_args(argv)

    from mic_tpu_torch.io.hub import push_to_hub

    url = push_to_hub(args.model_dir, args.repo_id, private=args.private,
                      commit_message=args.commit_message, token=args.token)
    print(f"pushed {args.model_dir} -> {url}")


if __name__ == "__main__":
    main()
