"""Sample and print dataset stories, the manual-inspection view of a split
(counterpart of `tools/demo_data.py`).

Usage:
  python -m multimodal_sequencing_tpu_torch.tools.demo_data \\
      --data_dir data/wikihow --data_name wikihow --split test -n 2
"""

from __future__ import annotations

import argparse
import textwrap

import numpy as np


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", required=True)
    parser.add_argument("--data_name", default="wikihow",
                        choices=["wikihow", "recipeqa"])
    parser.add_argument("--split", default="test")
    parser.add_argument("--version_text", default=None)
    parser.add_argument("-n", "--num_samples", type=int, default=1)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--scramble", action="store_true",
                        help="show a scrambled view + its order label")
    args = parser.parse_args(argv)

    from ..data.registry import get_processor
    proc = get_processor(f"{args.data_name}_sort", data_dir=args.data_dir,
                         version_text=args.version_text,
                         paired_with_image=False)
    getter = {"train": proc.get_train_examples,
              "dev": proc.get_dev_examples, "val": proc.get_dev_examples,
              "test": proc.get_test_examples}[args.split]
    examples = getter()
    rng = np.random.RandomState(args.seed)
    for k in range(min(args.num_samples, len(examples))):
        idx = rng.randint(len(examples))
        ex = examples[idx]
        print("=" * 70)
        print(f"Story {idx}: {ex.guid}")
        order = np.arange(len(ex.text_seq))
        if args.scramble:
            rng.shuffle(order)
            print(f"order label (chain): {np.argsort(order).tolist()}")
        for t, s in enumerate(order):
            img = (ex.img_path_seq[s] if ex.img_path_seq else None)
            print(f"--- step shown at {t} (true index {s}) "
                  f"{'[img: ' + str(img) + ']' if img else ''}")
            print(textwrap.fill(ex.text_seq[s], width=70))
        if ex.multiref_gt:
            print(f"multiref_gt: {ex.multiref_gt}")
    print("=" * 70)
    print(f"{len(examples)} stories in split {args.split}")


if __name__ == "__main__":
    main()
